"""serve_mfu: the analytic operations of the window's real prompt tokens
(the linear layers, causal attention over each prompt's own length, one
output-head row a request), over the window times the bfloat16 peak.
Pads are not counted: the work they cause is the padding's waste."""
from synbench.core import peaks


def read(run):
    f = run.facts
    if not f.get("requests") or not run.window_s > 0:
        return None
    return 100.0 * f["useful_flops"] / (run.window_s * peaks.BF16_FLOPS)

"""emulate_mfu: the H100 roofline time of the profiles the window
emulated (each sample's larger leg: its operations at the float32 peak,
since the compute atom's contract is float32 FMA work, or its bytes at
HBM's rate), as a share of the window.  One reader for every emulate
cell (``emulate_mfu.prompts``, ``emulate_mfu.decode``, ...)."""


def read(run):
    f = run.facts
    if not f.get("requests") or not run.window_s > 0:
        return None
    return 100.0 * f["roofline_s"] / run.window_s

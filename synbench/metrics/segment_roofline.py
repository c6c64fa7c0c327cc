"""segment_roofline: the segment launches' bound over their device time
in the trace.  The bound is each table row's larger leg, worked out from
the amounts the profile planned for that row, not from what the kernel
does.  A trace that holds another count of segment launches than the
program counted cannot be read."""
from synbench.core.roofline import share


def read(run):
    t, f = run.timeline, run.facts
    if t is None or not f.get("segment_launches"):
        return None
    ks = t.kernels(f["segment_symbol"])
    if len(ks) != f["segment_launches"]:
        return None
    return share(f["segment_bound_s"], sum(k.seconds for k in ks))

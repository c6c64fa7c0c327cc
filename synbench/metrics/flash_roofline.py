"""flash_roofline: the bfloat16 flash launches' bound over their device
time in the trace.  A launch's bound is the larger of its visible (query,
key) pairs' operations at the bfloat16 peak and its q, k, v and output
bytes, each once, at HBM's rate, worked out from its input shapes.  A
trace that holds another count of launches than the program counted
cannot be read."""
from synbench.core.roofline import share


def read(run):
    t, f = run.timeline, run.facts
    if t is None or not f.get("flash_launches"):
        return None
    ks = t.kernels(f["flash_symbol"])
    if len(ks) != f["flash_launches"]:
        return None
    return share(f["flash_bound_s"], sum(k.seconds for k in ks))

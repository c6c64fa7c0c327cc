"""launch_ms: host milliseconds a request spends launching its segment,
from entry to the kernel call's return: the table padded, its pinned copy,
the launch's grid and the launch (the program's span
``segment.launch``)."""
from synbench.core.program import ms_per_root, recorded


def read(run):
    return ms_per_root(recorded(run), ("segment.launch",), "emulate")

"""schedule_ms: host milliseconds a request spends compiling its iteration
table (the program's span ``schedule.compile``)."""
from synbench.core.program import ms_per_root, recorded


def read(run):
    return ms_per_root(recorded(run), ("schedule.compile",), "emulate")

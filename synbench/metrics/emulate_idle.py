"""emulate_idle: the share of the window in which the card ran nothing,
from the profiler's timeline."""


def read(run):
    return None if run.timeline is None else run.timeline.idle_share()

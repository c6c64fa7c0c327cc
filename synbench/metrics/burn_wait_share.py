"""burn_wait_share: the share of the segment kernel's burn time that its
burning CTAs spent waiting for a row of y to be published, over the
window: 100 x the program's counter ``segment.burn_wait_ns`` over its
``segment.burn_ns``.  The timed kernel sums both on the device's clock,
on lane 0 of warp 0 of each burning CTA (the ns it blocked on a row's
barrier, and the ns of its burns), and ``SegmentRunner`` adds them to the
counters when it reads them back.  A program without the counters gives
None."""
from synbench.core.program import counter, recorded


def read(run):
    p = recorded(run)
    waited, burned = counter(p, "segment.burn_wait_ns"), \
        counter(p, "segment.burn_ns")
    if not burned or waited is None:
        return None
    return 100.0 * waited / burned

"""Entry point used by ``repro_torch.core.schedule.SegmentRunner`` (backend
``"cuda"``)."""
from __future__ import annotations

import numpy as np

from repro_torch.kernels.segment import kernel


def segment(table, *, x=None, ring=None, w=None, kind: str = "all-reduce",
            timed: bool = False) -> kernel.SegmentRun:
    """One launch for a segment's ``table`` (rows padded or not: rows with
    no work are skipped on the device); ``x`` is the burn's operand,
    ``ring`` the memory atom's ``Ring`` and ``w`` the collective atom's
    wire carry (stepped by the loop body of ``kind``), each needed only
    when some row uses it; ``timed`` stamps the rows on a card."""
    t = np.asarray(table, dtype=np.int32)
    if timed:
        return kernel.run_segment(t, x, ring, w, kind, timed=True)
    # untimed, five arguments: a stand-in for run_segment need not take timed
    return kernel.run_segment(t, x, ring, w, kind)

"""Roofline arithmetic: the least time the card could take for an amount
of work, and a measured time's share of it."""
from __future__ import annotations

from typing import Optional


def bound_s(flops: float, nbytes: float, peak_flops: float,
            bytes_per_s: float) -> float:
    """The larger of the operations over the peak rate and the bytes over
    the memory rate."""
    return max(flops / peak_flops, nbytes / bytes_per_s)


def share(bound: float, measured: float) -> Optional[float]:
    """``bound`` over ``measured`` in percent, or None when nothing was
    measured (a share is never reported as 0 for want of a reading)."""
    if not measured > 0 or not bound > 0:
        return None
    return 100.0 * bound / measured

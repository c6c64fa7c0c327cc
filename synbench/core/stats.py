"""Quantiles as the benchmark reports them."""
from __future__ import annotations

import statistics
from typing import Sequence


def percentile(values: Sequence[float], p: int) -> float:
    """The ``p``-th percentile (1..99), interpolated between the samples
    (``statistics.quantiles`` with the inclusive method)."""
    if len(values) == 1:
        return float(values[0])
    return float(statistics.quantiles(values, n=100,
                                      method="inclusive")[p - 1])


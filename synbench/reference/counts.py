"""Shared arithmetic of the analytic counts: a product's operations and
the bytes of its operands and result, as a (flops, bytes) pair of
integers."""
from __future__ import annotations

from typing import Tuple

Count = Tuple[int, int]


def product(m: int, k: int, n: int, elem: int, batch: int = 1) -> Count:
    """``batch`` products of [m, k] by [k, n]: 2mkn operations each; the
    two operands and the result read or written once, ``elem`` bytes an
    element."""
    return (2 * batch * m * k * n,
            elem * batch * (m * k + k * n + m * n))


def add(*counts: Count) -> Count:
    return (sum(c[0] for c in counts), sum(c[1] for c in counts))

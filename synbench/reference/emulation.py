"""What an emulation must do, worked out again from the profile: the
paper's replay contract (consecutive identical samples replay as one run
of their count-scaled amounts, in order) and the atoms' published
quantization (a burn iteration is one ``tile`` x ``tile`` float32 product,
2 tile³ operations; a ring pass reads and writes one block, 2 x block
bytes; an amount rounds to the nearest whole number of them).

``burn`` and ``ring_values`` recompute the two legs' outputs: the burn's
carry y ← (y·x)·0.5 + 0.25 from x = 0.5·I, and each ring slot, filled with
ones, multiplied by 1.0000001 (float32) once a pass, pass p streaming slot
p mod slots.  Both in plain float32, TF32 off.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

STREAM_SCALE = np.float32(1.0000001)

Run = Tuple[float, float, int]          # (flops, hbm bytes, count)


def _key(r) -> tuple:
    return (r.flops, r.hbm_bytes, tuple(sorted(r.ici_bytes.items())),
            r.storage_read_bytes, r.storage_write_bytes)


def runs(samples) -> List[Run]:
    """Consecutive samples with identical resources, as (flops, bytes,
    count).  Only device legs: a profile with wire or storage bytes is
    not one this reference replays."""
    out: List[list] = []
    last = None
    for s in samples:
        r = s.resources
        if r.ici_bytes or r.storage_read_bytes or r.storage_write_bytes:
            raise ValueError("the emulation reference replays compute and "
                             "memory legs only")
        k = _key(r)
        if out and k == last:
            out[-1][2] += 1
        else:
            out.append([r.flops, r.hbm_bytes, 1])
            last = k
    return [tuple(o) for o in out]


def row_amounts(rs: Sequence[Run]) -> List[Tuple[float, float]]:
    """Each run's amounts scaled by its count (a run of one as it is)."""
    return [(f * c, b * c) if c > 1 else (f, b) for f, b, c in rs]


def table(rs: Sequence[Run], tile: int, block_bytes: int) -> np.ndarray:
    """The (n, 3) iteration table: burn iterations, ring passes, no wire."""
    rows = [(max(int(round(f / (2.0 * tile ** 3))), 0) if f > 0 else 0,
             max(int(round(b / (2.0 * block_bytes))), 0) if b > 0 else 0, 0)
            for f, b in row_amounts(rs)]
    return np.asarray(rows, dtype=np.int64).reshape(-1, 3)


def fold(rs: Sequence[Run]) -> Tuple[float, float]:
    """The consumed amounts: the rows' amounts added in order from 0."""
    flops = hbm = 0.0
    for f, b in row_amounts(rs):
        flops = flops + f
        hbm = hbm + b
    return flops, hbm


def roofline_s(samples, peak_flops: float, bytes_per_s: float) -> float:
    """The least time the profile's samples take on a card: each sample's
    larger leg, summed."""
    return sum(max(s.resources.flops / peak_flops,
                   s.resources.hbm_bytes / bytes_per_s) for s in samples)


def rows_bound_s(rs: Sequence[Run], peak_flops: float,
                 bytes_per_s: float) -> float:
    """The least time a segment of these rows takes: each row's larger
    leg, summed (rows are barriers; a row's two legs may overlap)."""
    return sum(max(f / peak_flops, b / bytes_per_s)
               for f, b in row_amounts(rs))


def burn(tile: int, iters: int, device, *, tf32: bool = False
         ) -> torch.Tensor:
    """The burn's carry after ``iters`` iterations from x = 0.5·I; the
    loop stops early once y is a fixed point (every later iteration gives
    the same bits).  ``tf32=True`` runs the products in TF32: the
    control."""
    x = torch.eye(tile, dtype=torch.float32, device=device) * 0.5
    y = x
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        for _ in range(iters):
            nxt = (y @ x) * 0.5 + 0.25
            if torch.equal(nxt, y):
                break
            y = nxt
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return y


def ring_values(slots: int, passes: int, *, dtype=np.float32) -> np.ndarray:
    """Each slot's value after ``passes`` passes numbered from 0 over a
    ring of ``slots`` slots of ones.  ``dtype=bfloat16``-like narrower
    types are the control's (pass a numpy dtype)."""
    counts = np.full(slots, passes // slots, dtype=np.int64)
    counts[: passes % slots] += 1
    v = np.ones(slots, dtype=dtype)
    scale = dtype(STREAM_SCALE) if dtype is not np.float32 else STREAM_SCALE
    for i in range(int(counts.max()) if slots else 0):
        live = counts > i
        v[live] = (v[live] * scale).astype(dtype)
    return v


def ring_values_fast(slots: int, passes: int) -> np.ndarray:
    """``ring_values`` in float32 by whole blocks of passes: while a value
    stays below 2 each multiply by 1 + 2⁻²³ adds exactly one unit in the
    last place, so k passes from 1 give 1 + k·2⁻²³ (checked against the
    pass-by-pass loop in the tests); above 2²² passes a slot it falls back
    to the loop."""
    counts = np.full(slots, passes // slots, dtype=np.int64)
    counts[: passes % slots] += 1
    if counts.max(initial=0) >= 1 << 22:
        return ring_values(slots, passes)
    return (np.float32(1.0) + counts.astype(np.float32)
            * np.float32(2.0 ** -23)).astype(np.float32)

"""Plain PyTorch version of the fused segment loop: the table walked on the
host, row by row, with the burn's iteration, the ring pass and the
collective loop body."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.kernels.collective.ref import loop as coll_loop
from repro_torch.kernels.compute_atom.ref import burn_step
from repro_torch.kernels.memory_atom.ref import ring_pass


def run_segment(table: np.ndarray, x: Optional[torch.Tensor],
                ring: Optional[torch.Tensor], *, start: int = 0,
                w: Optional[torch.Tensor] = None,
                kind: str = "all-reduce") -> Optional[torch.Tensor]:
    """Per row: ``row[0]`` burn iterations on y (from ``x``, carried across
    rows), then ``row[1]`` in-place passes over ``ring`` [slots, n],
    numbered from ``start``, then ``row[2]`` in-place steps of the
    collective loop body of ``kind`` on the wire carry ``w`` [n, block]
    (the mesh axis first).  Returns y, or None when no row burns."""
    y, p = None, start
    for ci, mi, wi in np.asarray(table).tolist():
        for _ in range(ci):
            y = burn_step(x if y is None else y, x)
        if mi:
            ring_pass(ring, start=p, passes=mi)
            p += mi
        if wi:
            coll_loop(w, dim=0, kind=kind, steps=wi)
    return y


def flops(tile: int, table: np.ndarray) -> float:
    return 2.0 * tile ** 3 * int(np.asarray(table)[:, 0].sum())


def bytes_moved(block_bytes: int, table: np.ndarray) -> float:
    return 2.0 * block_bytes * int(np.asarray(table)[:, 1].sum())

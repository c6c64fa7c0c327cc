"""The JAX package's ``stream`` entry on the card: chained passes.

``block``, ``block_bytes`` and ``iters`` are plain ints.  (The JAX
package's ``stream`` jits ``block_bytes`` as a traced argument and so cannot
run with it set.)  The memory atom does not chain: it streams a ring of
blocks larger than L2 (``kernel.stream_ring``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.memory_atom import kernel


def stream(x: torch.Tensor, *, iters: int, block: int = 1 << 15,
           block_bytes: int = 0) -> torch.Tensor:
    """``iters`` passes over x; ``block_bytes``, when set, gives the block
    in bytes (capped at the whole array), as the JAX package's does."""
    if block_bytes:
        block = min(block_bytes // x.element_size(), x.shape[0])
    block = min(block, x.shape[0])
    return kernel.stream_passes(x, block=block, passes=iters)

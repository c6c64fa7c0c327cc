"""Synapse compute atom: the tile burn on a CUDA card.

The paper's compute atom is "a loop of assembly code that efficiently
performs a matrix multiplication", sized to stay cache-resident, whose loop
rate throttles emulated efficiency.  Here it is ``csrc/compute_atom.cu``:
``iters`` chained float32 products ``y <- (y @ x) * 0.5 + 0.25`` of a
``tile x tile`` operand, one launch an iteration, with the tile resident in
L2 (the source says why, and what bounds it).

``burn_tile`` launches the kernel for a CUDA tensor and the plain version
(``ref.burn_tile``) for a CPU tensor; any other input raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.compute_atom import ref

#: kernel launches issued by ``burn_tile`` (one an iteration; CUDA only)
launches = 0


def check_input(x: torch.Tensor, iters: int) -> int:
    """Validate a burn operand; returns its tile size."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"burn_tile takes a tensor, got {type(x).__name__}")
    if x.dtype != torch.float32:
        raise TypeError(f"burn_tile takes float32, got {x.dtype}")
    if x.dim() != 2 or x.shape[0] != x.shape[1] or x.shape[0] % 8:
        raise ValueError(f"burn_tile takes a square [tile, tile] operand "
                         f"with tile % 8 == 0, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("burn_tile takes a contiguous operand")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"burn_tile runs on cpu or cuda, not {x.device}")
    if not isinstance(iters, int) or iters < 0:
        raise ValueError(f"iters must be an int >= 0, got {iters!r}")
    return int(x.shape[0])


def burn_tile(x: torch.Tensor, *, iters: int) -> torch.Tensor:
    """x: [tile, tile] float32 -> same shape; ``iters`` chained products."""
    global launches
    tile = check_input(x, iters)
    if iters == 0:
        return x.clone()
    if x.device.type == "cpu":
        return ref.burn_tile(x, iters=iters)
    lib = build.load()
    out = torch.empty_like(x)
    scratch = torch.empty_like(x)
    err = lib.synapse_burn_tile(
        x.data_ptr(), out.data_ptr(), scratch.data_ptr(), tile, iters,
        x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, "burn_tile")
    launches += iters
    return out

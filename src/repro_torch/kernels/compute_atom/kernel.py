"""Synapse compute atom: the tile burn on a CUDA card.

The paper's compute atom is "a loop of assembly code that efficiently
performs a matrix multiplication", sized to stay cache-resident, whose loop
rate throttles emulated efficiency.  Here it is ``csrc/compute_atom.cu``:
``iters`` chained float32 products ``y <- (y @ x) * 0.5 + 0.25`` of a
``tile x tile`` operand.  At tiles 64, 128 and 256 (every tile the emulator
uses) one launch runs the whole burn: thread-block clusters of 2 CTAs, each
cluster owning a panel of 4 rows, with x resident in registers.  Other
tiles launch one kernel an iteration.  The source says why, and what bounds
it.

``burn_tile`` launches the kernel for a CUDA tensor and the plain version
(``ref.burn_tile``) for a CPU tensor; any other input raises.
"""
from __future__ import annotations

import threading

import torch

from repro_torch.kernels import build
from repro_torch.kernels.compute_atom import ref

#: kernel launches issued by ``burn_tile`` (CUDA only): one a call at the
#: tiles that run a burn in one launch, one an iteration at other tiles
launches = 0
#: iterations burned by those launches
iterations = 0
#: guards both counters: a thread fleet on the kernel backend burns from
#: several threads at once, and ``+=`` on a global can lose a count
_count_lock = threading.Lock()


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
    if x.device.type == "cuda" and x.data_ptr() % 16:
        raise ValueError("burn_tile takes a 16-byte aligned operand")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"burn_tile runs on cpu or cuda, not {x.device}")
    if not isinstance(iters, int) or iters < 0:
        raise ValueError(f"iters must be an int >= 0, got {iters!r}")
    return int(x.shape[0])


def burn_tile(x: torch.Tensor, *, iters: int) -> torch.Tensor:
    """x: [tile, tile] float32 -> same shape; ``iters`` chained products."""
    global launches, iterations
    tile = check_input(x, iters)
    if iters == 0:
        return x.clone()
    if x.device.type == "cpu":
        return ref.burn_tile(x, iters=iters)
    lib = build.load()
    n_launches = lib.synapse_burn_tile_launches(tile, iters)
    out = torch.empty_like(x)
    # the one-launch kernel needs no second buffer
    scratch = torch.empty_like(x) if n_launches > 1 else None
    err = lib.synapse_burn_tile(
        x.data_ptr(), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(), tile, iters,
        x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, "burn_tile")
    with _count_lock:
        launches += n_launches
        iterations += iters
    return out

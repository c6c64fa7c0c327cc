"""Synapse memory atom: streaming passes through device memory.

The paper's memory atom malloc/frees tunable buffers; on a card the
analogous resource is device-memory bandwidth.  ``csrc/memory_atom.cu``
streams the array through the SMs (read, scale by 1.0000001, write), so
bytes moved = 2 * size * passes.  ``block`` is the paper's tunable block
knob (§IV-E.3) as the JAX package defines it: it is validated
(``n % block == 0``) but does not set the kernel's geometry, which fills
the card on its own.

``stream_passes`` launches the kernel for a CUDA tensor and the plain
version (``ref.stream_pass`` repeated) for a CPU tensor; any other input
raises.
"""
from __future__ import annotations

import threading

import torch

from repro_torch.kernels import build
from repro_torch.kernels.memory_atom import ref

#: kernel launches issued by ``stream_passes`` (one a pass; CUDA only)
launches = 0
#: guards the counter: a thread fleet on the kernel backend streams from
#: several threads at once, and ``+=`` on a global can lose a count
_count_lock = threading.Lock()

#: dtype codes of the C interface
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def check_input(x: torch.Tensor, block: int, passes: int) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"stream_pass takes a tensor, got {type(x).__name__}")
    if x.dtype not in DTYPES:
        raise TypeError(f"stream_pass takes float32 or bfloat16, "
                        f"got {x.dtype}")
    if x.dim() != 1 or x.shape[0] == 0:
        raise ValueError(f"stream_pass takes a non-empty 1-D array, "
                         f"got shape {tuple(x.shape)}")
    if not isinstance(block, int) or block <= 0 or x.shape[0] % block:
        raise ValueError(f"n % block must be 0, got n={x.shape[0]}, "
                         f"block={block!r}")
    if not x.is_contiguous():
        raise ValueError("stream_pass takes a contiguous array")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"stream_pass runs on cpu or cuda, not {x.device}")
    if x.device.type == "cuda" and x.data_ptr() % 16:
        raise ValueError("stream_pass takes a 16-byte aligned array")
    if not isinstance(passes, int) or passes < 0:
        raise ValueError(f"passes must be an int >= 0, got {passes!r}")


def stream_passes(x: torch.Tensor, *, block: int,
                  passes: int) -> torch.Tensor:
    """``passes`` read+write passes over x [n] (n % block == 0)."""
    global launches
    check_input(x, block, passes)
    if passes == 0:
        return x.clone()
    if x.device.type == "cpu":
        y = x
        for _ in range(passes):
            y = ref.stream_pass(y, block=block)
        return y
    lib = build.load()
    out = torch.empty_like(x)
    scratch = torch.empty_like(x)
    err = lib.synapse_stream_pass(
        x.data_ptr(), out.data_ptr(), scratch.data_ptr(), x.shape[0],
        DTYPES[x.dtype], passes, x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, "stream_pass")
    with _count_lock:
        launches += passes
    return out


def stream_pass(x: torch.Tensor, *, block: int) -> torch.Tensor:
    """One read+write pass over x [n] (n % block == 0)."""
    return stream_passes(x, block=block, passes=1)

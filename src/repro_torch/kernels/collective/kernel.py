"""Synapse collective atom on a CUDA card: a mesh's collectives with every
shard on one device.

A mesh's shards are one float32 tensor (``repro_torch.launch.mesh``); a
collective runs along dimension ``dim``, the mesh axis.
``csrc/collective.cu`` is the per-sample collective of the JAX package's
``CollectiveAtom._coll_fn`` (psum, all_gather, ppermute; out of place,
all-gather's output grown by the axis).  The fused loop body runs only
inside the segment kernel (``csrc/coll.cuh``, ``kernels/segment``).  The
source says what bounds the kernel and why it is shaped so.

``collective`` launches the kernel for a CUDA tensor and the plain version
(``ref.collective``) for a CPU tensor; anything else raises.
"""
from __future__ import annotations

import math
import threading

import torch

from repro_torch.kernels import build
from repro_torch.kernels.collective import ref

#: kind -> the C interface's code
KIND_CODES = {"all-reduce": 0, "all-gather": 1, "collective-permute": 2}

#: kernel launches issued by ``collective`` (one a call; CUDA only)
launches = 0
#: guards the counters: a thread fleet launches from several threads
_count_lock = threading.Lock()


def check_input(x: torch.Tensor, dim: int, kind: str) -> int:
    """Validate a mesh's shards; returns ``dim`` as a non-negative int."""
    if kind not in KIND_CODES:
        raise ValueError(f"unknown collective {kind!r}; choose one of "
                         f"{tuple(KIND_CODES)}")
    if not isinstance(x, torch.Tensor) or x.dtype != torch.float32:
        raise TypeError(f"a collective takes a float32 tensor, got "
                        f"{getattr(x, 'dtype', type(x).__name__)}")
    if x.dim() < 2 or x.numel() == 0:
        raise ValueError(f"a collective takes the shards as a tensor of "
                         f"shape (*mesh, block), got {tuple(x.shape)}")
    nd = x.dim()
    if not isinstance(dim, int) or not -nd <= dim < nd or dim % nd == nd - 1:
        raise ValueError(f"dim {dim!r} is not a mesh axis of shape "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("a collective takes contiguous shards")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"a collective runs on cpu or cuda, not {x.device}")
    return dim % nd


def _view(x: torch.Tensor, dim: int):
    """(outer, n, post, blk): the shards seen around the axis."""
    shape = tuple(x.shape)
    return (math.prod(shape[:dim]), shape[dim],
            math.prod(shape[dim + 1:-1]), shape[-1])


def collective(x: torch.Tensor, *, dim: int, kind: str) -> torch.Tensor:
    """The per-sample collective of ``kind`` along ``dim`` of the shards x
    [*mesh, block]; a new tensor ([*mesh, n, block] for all-gather)."""
    global launches
    dim = check_input(x, dim, kind)
    if x.device.type == "cpu":
        return ref.collective(x, dim=dim, kind=kind)
    outer, n, post, blk = _view(x, dim)
    shape = (tuple(x.shape[:-1]) + (n, blk) if kind == "all-gather"
             else tuple(x.shape))
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    lib = build.load()
    err = lib.synapse_collective(
        x.data_ptr(), out.data_ptr(), outer, n, post, blk, KIND_CODES[kind],
        x.device.index if x.device.index is not None
        else torch.cuda.current_device(),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, "collective")
    with _count_lock:
        launches += 1
    return out


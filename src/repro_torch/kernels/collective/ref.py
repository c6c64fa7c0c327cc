"""Plain PyTorch version of the collective atom: a mesh's shards as one
tensor, the collective along dimension ``dim`` (the mesh axis)."""
from __future__ import annotations

import torch

#: the collectives the atom moves wire bytes with
KINDS = ("all-reduce", "all-gather", "collective-permute")


def ascending_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The sum over ``dim`` in ascending shard order from 0, kept as a
    dimension of 1: the order the kernels sum in, so the two agree to the
    last bit at any n (``torch.sum`` may take another order)."""
    s = torch.zeros_like(x.select(dim, 0))
    for i in range(x.shape[dim]):
        s += x.select(dim, i)
    return s.unsqueeze(dim)


def collective(x: torch.Tensor, *, dim: int, kind: str) -> torch.Tensor:
    """The per-sample collective (``CollectiveAtom._coll_fn``): all-reduce
    writes the sum over ``dim`` (no 1/n, in ascending shard order) to
    every shard; all-gather gives every shard all n blocks (the output
    grows a dimension of n before the last); collective-permute gives
    shard (i + 1) % n shard i's block."""
    if kind == "all-gather":
        g = x.movedim(dim, -2)
        shape = list(x.shape[:-1]) + list(g.shape[-2:])
        return g.unsqueeze(dim).expand(shape).contiguous()
    if kind == "collective-permute":
        return torch.roll(x, shifts=1, dims=dim)
    return ascending_sum(x, dim).expand_as(x).contiguous()


def loop_step(x: torch.Tensor, *, dim: int, kind: str) -> torch.Tensor:
    """One step of the fused loop body (``CollectiveAtom.loop_body``),
    shape-invariant: all-reduce is the sum (in ascending shard order)
    times 1/n, all-gather every shard taking shard 0's block."""
    n = x.shape[dim]
    if kind == "all-gather":
        return x.select(dim, 0).unsqueeze(dim).expand_as(x).contiguous()
    if kind == "collective-permute":
        return torch.roll(x, shifts=1, dims=dim)
    return (ascending_sum(x, dim) * (1.0 / n)).expand_as(x).contiguous()


def loop(x: torch.Tensor, *, dim: int, kind: str,
         steps: int) -> torch.Tensor:
    """``steps`` loop-body steps on ``x``, in place, as the kernel runs
    them; returns x."""
    for _ in range(steps):
        x.copy_(loop_step(x, dim=dim, kind=kind))
    return x


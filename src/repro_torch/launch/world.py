"""Worlds of ranks: processes joined by a real ``torch.distributed``
process group, each holding its own shards on its own device.

This is where the port's meshes hold shards on distinct ranks, the
counterpart of the JAX package's meshes over several devices (its tests
force eight host devices; here eight CPU processes over gloo play them).

* ``init_world`` joins a rank to its world through a store: a
  ``FileStore`` in a directory the caller names (no ports, so parallel
  test files cannot collide) or any ``torch.distributed.Store`` (a
  ``TCPStore`` on localhost).  The backend is an explicit choice and
  nothing swaps one for another: ``"nccl"`` where each rank has a card of
  its own (asked for ranks that share one, it raises), ``"gloo"`` for CPU
  ranks or for ranks that share a card (gloo stages CUDA tensors through
  the host).
* ``spawn`` runs ``fn(rank, *args)`` on every rank of a new world, each a
  process started by ``torch.multiprocessing`` with the spawn method, and
  returns rank 0's result.  A rank that raises fails the call with its
  traceback; a deadline ends a hung world.
* ``device_mesh`` is a ``DeviceMesh`` over the world, for the sharded
  train and serve steps (DTensors with real shards).  ``RankMesh`` is the
  emulator's ``Mesh`` over the world (``shared`` False): this rank owns
  one shard, on its own device, and the collective atom moves its wire
  bytes over the axis's process group.
"""
from __future__ import annotations

import faulthandler
import math
import os
import queue
import time
import traceback
from datetime import timedelta
from typing import Any, Callable, Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike
from repro_torch.launch.mesh import Mesh

BACKENDS = ("gloo", "nccl")

#: seconds a collective waits for the other ranks of its group
TIMEOUT_S = 300.0

#: blocks of the wire carry a group call moves at most (``RankMesh.loop``):
#: 512 x 128 KiB = 64 MiB a call
WIRE_BATCH = 512


def rank_device(rank: int, world: int, device: DeviceLike = "cuda"
                ) -> torch.device:
    """The device rank ``rank`` of ``world`` runs on: the CPU, or card
    ``rank % cards`` (ranks share the cards when the world has more ranks
    than the host has cards)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA world needs a card and none is available; "
                           "pass device='cpu' for CPU ranks")
    return torch.device("cuda", rank % torch.cuda.device_count())


def shares_a_card(world: int, device: DeviceLike = "cuda") -> bool:
    """Whether ranks of ``world`` on ``device`` would share a card."""
    return torch.device(device).type == "cuda" and \
        world > torch.cuda.device_count()


def init_world(rank: int, world: int, store, backend: str,
               device: DeviceLike = "cuda") -> torch.device:
    """Join rank ``rank`` to a process group of ``world`` ranks and return
    its device (``rank_device``; the current CUDA device where it is a
    card).  ``store``: a directory, where the ranks meet in a
    ``FileStore``, or a ``torch.distributed.Store``.  ``backend``:
    ``"gloo"`` or ``"nccl"``; NCCL needs each rank on a card of its own and
    raises for CPU ranks or ranks that share a card.  A collective waits
    ``TIMEOUT_S`` for the other ranks."""
    import torch.distributed as dist
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    dev = rank_device(rank, world, device)
    if backend == "nccl" and (dev.type != "cuda"
                              or shares_a_card(world, device)):
        raise ValueError(
            f"nccl needs each rank on a card of its own: {world} ranks on "
            f"{torch.cuda.device_count() if dev.type == 'cuda' else 0} "
            "card(s); use backend='gloo' for CPU ranks or ranks that share "
            "a card")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        if backend == "gloo":
            _stage_cuda_gather()
    if isinstance(store, (str, os.PathLike)):
        store = dist.FileStore(os.path.join(os.fspath(store), "store"),
                               world)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world,
                            timeout=timedelta(seconds=TIMEOUT_S),
                            device_id=dev if backend == "nccl" else None)
    return dev


#: the library holding ``_stage_cuda_gather``'s kernel (kept: a kernel
#: lives as long as its library)
_GLOO_CUDA_LIB = None


def _stage_cuda_gather() -> None:
    """Give the functional all-gather (``_c10d_functional``'s, which
    DTensor and ``RankMesh`` call) a CUDA kernel that gathers a host copy
    of the input and copies the result back, on the current stream.
    Under gloo, the functional all-gather of CUDA tensors ends both ranks
    with a segmentation fault at every size (torch 2.11 on an H100),
    while the functional all-reduce, reduce-scatter and all-to-all of
    CUDA tensors, and c10d's all-gather, give the right values.  gloo
    stages a CUDA tensor through the host anyway, so the staging here
    costs what gloo's would.  Once a process."""
    global _GLOO_CUDA_LIB
    if _GLOO_CUDA_LIB is not None:
        return
    op = torch.ops._c10d_functional.all_gather_into_tensor

    def gather(x, group_size, group_name):
        out = op(x.cpu(), group_size, group_name)
        return torch.ops._c10d_functional.wait_tensor(out).to(x.device)
    lib = torch.library.Library("_c10d_functional", "IMPL")
    lib.impl("all_gather_into_tensor", gather, "CUDA")
    _GLOO_CUDA_LIB = lib


def close_world() -> None:
    """Leave the process group ``init_world`` joined, if any."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def _rank_main(rank, world, fn, args, store, backend, device, results):
    """A rank's process: join the world, run ``fn``, report the result or
    the traceback, leave.  CPU ranks share the host's cores, each taking
    its part of them for its intra-op threads.  A rank that dies on a
    signal prints its Python stack first (``faulthandler``)."""
    faulthandler.enable()
    try:
        if torch.device(device).type == "cpu":
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        init_world(rank, world, store, backend, device)
        out = fn(rank, *args)
        results.put(("ok", rank, out))
    except BaseException:        # reported, then this process ends
        results.put(("err", rank, traceback.format_exc()))
    finally:
        # the report is on its way before the group's teardown, which
        # may end the process when another rank left first
        results.close()
        results.join_thread()
        try:
            close_world()
        except RuntimeError:
            pass


def spawn(fn: Callable, world: int, *args, store: str,
          backend: str = "gloo", device: DeviceLike = "cuda",
          timeout: float = 600.0) -> Any:
    """Run ``fn(rank, *args)`` on ``world`` new processes joined by
    ``init_world`` and return rank 0's result.

    ``fn``, ``args`` and the results cross process boundaries pickled, so
    ``fn`` is a module-level function.  ``store``: the directory the ranks
    meet in (one a world).  A rank that raises, or dies, fails the call with a ``RuntimeError`` holding
    its traceback, and the other ranks are ended; past ``timeout`` seconds
    every rank is ended and the call raises ``TimeoutError``."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    os.makedirs(store, exist_ok=True)
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, fn, args, store, backend, device,
                               results), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    got: Dict[int, Any] = {}
    try:
        while len(got) < world:
            try:
                status, rank, out = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(
                        f"rank {dead[0]} of {world} died with exit code "
                        f"{procs[dead[0]].exitcode} and no report")
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"{world - len(got)} of {world} ranks did not "
                        f"finish in {timeout:.0f} s (waiting: "
                        f"{sorted(set(range(world)) - set(got))})")
                continue
            if status == "err":
                raise RuntimeError(f"rank {rank} of {world} failed:\n{out}")
            got[rank] = out
    finally:
        for p in procs:
            p.join(timeout=5.0 if len(got) == world else 0.1)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
    return got[0]


def device_mesh(shape: Sequence[int], axes: Sequence[str],
                device: DeviceLike):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the world this
    process joined, ranks in row-major mesh order, of the type of
    ``device``, the rank's device (``init_world``'s result): DTensors on it
    hold real shards, one a rank, and their collectives move data."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if math.prod(shape) != dist.get_world_size():
        raise ValueError(f"a mesh of {shape} needs {math.prod(shape)} "
                         f"ranks; the world has {dist.get_world_size()}")
    return init_device_mesh(torch.device(device).type, shape,
                            mesh_dim_names=axes)


class RankMesh(Mesh):
    """A ``Mesh`` whose shards live on distinct ranks: this process owns
    the shard at its rank's coordinates, on its own device, and a
    collective along an axis runs over the process group of the ranks that
    share the other coordinates.  Shard ids are the global
    ranks in mesh order, the JAX package's ``d.id``, so that plan keys are
    the same tuple as on a shared mesh of the same shape.

    ``collective`` and ``loop`` move a rank's block over an axis's group
    and count what they moved: ``wire_calls`` group calls, ``wire_steps``
    loop-body steps (``loop``) and ``wire_bytes``, the ring model's bytes
    this rank sent (``collective_factor`` of the kind times the bytes of
    its block), the bytes a schedule's quantization emulates."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str],
                 device: DeviceLike = None):
        import torch.distributed as dist
        super().__init__(shape, axes, device)
        self.shared = False
        if self.size != dist.get_world_size():
            raise ValueError(f"a mesh of {tuple(self.shape.values())} needs "
                             f"{self.size} ranks; the world has "
                             f"{dist.get_world_size()}")
        self.rank = dist.get_rank()
        dims = tuple(self.shape.values())
        self.coords: Tuple[int, ...] = tuple(
            int(c) for c in np.unravel_index(self.rank, dims))
        self._groups: Dict[str, Any] = {}
        ranks = np.arange(self.size).reshape(dims)
        # every rank makes every group, in one order (new_group is
        # collective over the world)
        for i, axis in enumerate(self.axis_names):
            lines = ranks.swapaxes(i, -1).reshape(-1, self.shape[axis])
            for line in lines.tolist():
                g = dist.new_group(line)
                if self.rank in line:
                    self._groups[axis] = (g, line)
        self.wire_calls = 0
        self.wire_steps = 0
        self.wire_bytes = 0.0

    def loop_operand(self, block_elems: int) -> torch.Tensor:
        """The wire carry of a fused segment on this rank: ``WIRE_BATCH``
        blocks of ``block_elems`` float32 ones, a fixed point of every
        kind's step, so that ``loop`` moves up to that many steps a call."""
        return torch.ones((WIRE_BATCH, block_elems), dtype=torch.float32,
                          device=self.device)

    def collective(self, x: torch.Tensor, axis: str, kind: str
                   ) -> torch.Tensor:
        """The per-sample collective on this rank's block ``x`` over
        ``axis``'s group, as a new tensor: the sum of the axis's blocks
        (all-reduce), the axis's n blocks, [n, *x.shape] (all-gather), or
        the block of the rank before this one along the axis
        (collective-permute).  All-reduce and all-gather are functional
        collectives (``_c10d_functional``), which the operator counter
        counts."""
        import torch.distributed as dist
        from repro_torch.core.atoms import collective_factor
        group, line = self._groups[axis]
        n = len(line)
        self.wire_calls += 1
        self.wire_bytes += collective_factor(kind, n) * \
            x.numel() * x.element_size()
        if kind == "all-gather":
            out = torch.ops._c10d_functional.all_gather_into_tensor(
                x.contiguous(), n, group.group_name)
            out = torch.ops._c10d_functional.wait_tensor(out)
            return out.view(n, *x.shape)
        if kind == "collective-permute":
            # gloo's point-to-point calls take host tensors only (a CUDA
            # one ends the rank), so a card's block goes through the host
            # there, as gloo stages its collectives' CUDA tensors
            host = x.is_cuda and dist.get_backend(group) == "gloo"
            send = (x.cpu() if host else x).contiguous()
            recv = torch.empty_like(send)
            i = line.index(self.rank)
            ops = [dist.P2POp(dist.isend, send, line[(i + 1) % n], group),
                   dist.P2POp(dist.irecv, recv, line[(i - 1) % n], group)]
            for work in dist.batch_isend_irecv(ops):
                work.wait()
            return recv.to(x.device) if host else recv
        out = torch.ops._c10d_functional.all_reduce(
            x.contiguous(), "sum", group.group_name)
        return torch.ops._c10d_functional.wait_tensor(out)

    def loop(self, w: torch.Tensor, axis: str, kind: str,
             steps: int) -> torch.Tensor:
        """``steps`` steps of the collective atom's loop body on the wire
        carry ``w`` [blocks, block], in place: all-reduce the sum over the
        axis times 1/n, all-gather the axis's first block, permute the
        block of the rank before.  ``k`` steps go as one group call over
        ``k`` blocks of ``w`` (at most ``w``'s first dimension a call),
        which moves the wire bytes of ``k`` one-block steps; from ones,
        a fixed point of every kind, the values are those of ``k`` steps
        one at a time.  Returns ``w``."""
        n = self.shape[axis]
        left = steps
        while left > 0:
            k = min(left, w.shape[0])
            part = w[:k]
            got = self.collective(part, axis, kind)
            if kind == "all-gather":
                got = got[0]
            elif kind == "all-reduce":
                got = got * (1.0 / n)
            part.copy_(got)
            left -= k
        self.wire_steps += steps
        return w

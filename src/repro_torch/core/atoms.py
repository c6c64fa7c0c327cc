"""Emulation atoms: small self-contained consumers of one resource type.

Paper §IV-B, on a CUDA card:

  * ComputeAtom    — float32 matmul burn loop.  ``efficiency`` < 1
                     throttles it exactly like the paper's loop-rate knob
                     (emulate an app running below peak).  Backends:
                     ``"torch"`` (a loop of PyTorch ops) or ``"cuda"``, the
                     hand-written kernel in ``repro_torch.kernels.compute_atom``.
  * MemoryAtom     — streams a target byte count through device memory
                     (``"cuda"``: the kernel in
                     ``repro_torch.kernels.memory_atom``; ``"torch"``: a
                     scaled copy loop).
  * StorageAtom    — block-wise file write/read (libc read/write, unchanged
                     from the paper; block size is the tunable the paper
                     discusses in §IV-E.3).

The collective atom is not ported yet: ``CollectiveSpec`` and
``CollectiveQuant`` are here so schedules quantized for a mesh load and
compare, but nothing executes wire bytes.

Atoms expose ``plan(amount) -> Plan`` so the emulator can pre-plan, and
``seconds(amount, hw)`` — the model cost used by the TTC predictor.  A
``Plan`` separates *launch* (enqueue device work, returns the unsynced
output tensor; host plans do the work and return ``None``) from *sync*, so
the emulator can dispatch every atom of a sample asynchronously and wait
once at the sample barrier; calling the plan is the blocking contract.
"""
from __future__ import annotations

import os
import tempfile
import threading
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.calibrate import HostCalibration
from repro_torch.core.hardware import HardwareSpec
from repro_torch.device import DeviceLike, resolve, sync
from repro_torch.kernels.compute_atom import ops as catom_ops
from repro_torch.kernels.memory_atom import ops as matom_ops

#: atom backends: a loop of PyTorch ops, or the hand-written CUDA kernels
#: (which run their plain versions on CPU tensors)
BACKENDS = ("torch", "cuda")


def check_backend(backend: str) -> str:
    if backend not in BACKENDS:
        raise ValueError(f"unknown atom backend {backend!r}; "
                         f"choose one of {BACKENDS}")
    return backend


class Plan:
    """One planned resource consumption.

    ``launch()`` enqueues the work: device plans return the unsynced output
    tensor (dispatch only — caller syncs at the sample barrier), host plans
    (storage) do the work inline and return ``None``.  Calling the plan is
    the blocking contract: launch, sync, and return the amount the plan
    actually emulates (quantized, so cache sharers agree on what was
    consumed).
    """

    __slots__ = ("launch", "amount")

    def __init__(self, launch: Callable[[], object], amount: float):
        self.launch = launch
        self.amount = float(amount)

    def __call__(self) -> float:
        token = self.launch()
        if token is not None:
            sync(token)
        return self.amount

    @staticmethod
    def noop() -> "Plan":
        return Plan(lambda: None, 0.0)


class PlanCache:
    """Shared, keyed memo of planned atom thunks.

    Keys are the atom's full plan signature — (kind, backend/config knobs,
    quantized amount) — so identical (atom, amount) plans across emulators
    sharing the cache are built exactly once.  A plan holds its operand on
    its atom's device, so one cache serves atoms of one device.  Builds hold
    a per-key guard, not the cache-wide lock: concurrent builders of
    *different* plans run concurrently, while a second caller asking for a
    key mid-build waits for the first builder instead of constructing a
    duplicate.  The returned plans are safe to execute concurrently
    (read-only operands).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._plans: Dict[Tuple, Plan] = {}
        self._building: Dict[Tuple, threading.Event] = {}
        self.plans_built = 0
        self.hits = 0

    def get_or_build(self, key: Tuple,
                     builder: Callable[[], Plan]) -> Plan:
        while True:
            with self._lock:
                plan = self._plans.get(key)
                if plan is not None:
                    self.hits += 1
                    return plan
                done = self._building.get(key)
                if done is None:
                    done = threading.Event()
                    self._building[key] = done
                    owner = True
                else:
                    owner = False
            if not owner:
                # someone else is building this key: wait, then re-check
                # (a failed build wakes us with no plan — we take over)
                done.wait()
                continue
            try:
                plan = builder()
            except BaseException:
                with self._lock:
                    self._building.pop(key, None)
                done.set()
                raise
            with self._lock:
                self._plans[key] = plan
                self.plans_built += 1
                self._building.pop(key, None)
            done.set()
            return plan

    def __len__(self) -> int:
        return len(self._plans)

    def stats(self) -> Dict[str, int]:
        return {"plans_built": self.plans_built, "hits": self.hits,
                "size": len(self._plans)}


# ---------------------------------------------------------------------------
# Picklable atom configs: the knob surface of an atom, detached from its
# live state (calibration, device tensors).  A spec crosses a process
# boundary and ``build()``s a fresh atom on the far side.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ComputeSpec:
    tile: int = 256
    efficiency: float = 1.0
    backend: str = "torch"

    def build(self, calib=None, device: DeviceLike = None) -> "ComputeAtom":
        return ComputeAtom(calib, tile=self.tile, efficiency=self.efficiency,
                           backend=self.backend, device=device)


@dataclass(frozen=True)
class MemorySpec:
    block_bytes: int = 1 << 24
    backend: str = "torch"

    def build(self, calib=None, device: DeviceLike = None) -> "MemoryAtom":
        return MemoryAtom(calib, block_bytes=self.block_bytes,
                          backend=self.backend, device=device)


@dataclass(frozen=True)
class StorageSpec:
    block_bytes: int = 1 << 20
    # no directory: scratch files belong to the host the atom runs on

    def build(self, calib=None) -> "StorageAtom":
        return StorageAtom(calib, block_bytes=self.block_bytes)


#: per-shard float32 elements one fused collective iteration moves (the
#: collective analogue of ComputeAtom.tile / MemoryAtom.block_bytes — the
#: schedule compiler quantizes wire bytes into repeats of this block)
COLL_BLOCK_ELEMS = 1 << 15


def collective_factor(kind: str, n: int) -> float:
    """Ring-model wire bytes per chip per shard byte for a collective over
    an ``n``-way axis (all-reduce moves ``2*(n-1)/n`` of the shard, …)."""
    return {"all-reduce": 2.0 * (n - 1) / n,
            "all-gather": (n - 1) / n,
            "collective-permute": 1.0}.get(kind, 2.0 * (n - 1) / n)


@dataclass(frozen=True)
class CollectiveQuant:
    """Picklable wire-byte quantization for fused collective segments.

    Derivable from a (``CollectiveSpec``, mesh-spec) pair on a host that
    owns no mesh at all (``CollectiveSpec.quant_for``), so schedule tables
    quantized here are bit-identical to the JAX package's.  One iteration
    is one collective call over a fixed ``block_elems``-per-shard float32
    block, so the emulated wire amount is ``iters * wire_bytes_per_iter`` —
    quantized exactly like compute flops and memory bytes are.
    """
    n: int                               # collective axis size
    kind: str = "all-reduce"
    block_elems: int = COLL_BLOCK_ELEMS

    @property
    def factor(self) -> float:
        return collective_factor(self.kind, self.n)

    @property
    def wire_bytes_per_iter(self) -> float:
        return self.factor * 4.0 * self.block_elems

    def iters_for(self, wire_bytes: float) -> int:
        per_iter = self.wire_bytes_per_iter
        if per_iter <= 0.0:        # n == 1: there is no wire to move
            return 0
        return max(int(round(wire_bytes / per_iter)), 0)

    def emulated_bytes(self, iters: int) -> float:
        return iters * self.wire_bytes_per_iter

    def to_dict(self) -> Dict:
        return {"n": self.n, "kind": self.kind,
                "block_elems": self.block_elems}

    @staticmethod
    def from_dict(d) -> "CollectiveQuant":
        return CollectiveQuant(n=int(d["n"]), kind=str(d["kind"]),
                               block_elems=int(d["block_elems"]))


#: where the collective atom stands in the plan of work
COLLECTIVE_TODO = ("the collective atom is not ported yet "
                   "(ROADMAP.md, queue 2, item 3: CollectiveAtom "
                   "on torch.distributed)")


@dataclass(frozen=True)
class CollectiveSpec:
    axis: Optional[str] = None           # None: the mesh's last axis
    kind: str = "all-reduce"

    def quant_for(self, mesh_spec) -> CollectiveQuant:
        """Quantization for the mesh a *worker* will build from
        ``mesh_spec`` (anything with ``shape``/``axes``) — no live mesh
        required."""
        axes = tuple(mesh_spec.axes)
        axis = self.axis if self.axis is not None else axes[-1]
        if axis not in axes:
            raise ValueError(f"collective axis {axis!r} not in mesh axes "
                             f"{axes}")
        return CollectiveQuant(n=int(mesh_spec.shape[axes.index(axis)]),
                               kind=self.kind)


class Atom:
    resource = "abstract"
    cache: Optional[PlanCache] = None      # set by plan-sharing emulators

    def plan(self, amount: float) -> Plan:
        """Returns a Plan that consumes ``amount`` (quantized) when called."""
        raise NotImplementedError

    def seconds(self, amount: float, hw: HardwareSpec) -> float:
        raise NotImplementedError

    def _cached(self, key: Tuple, builder: Callable[[], Plan]) -> Plan:
        if self.cache is None:
            return builder()
        return self.cache.get_or_build(key, builder)


def compute_burn_body(c: torch.Tensor) -> torch.Tensor:
    """One compute-atom iteration of the ``"torch"`` backend: tile matmul
    kept bounded by tanh.  Shared with the fused segment loop so both
    paths burn identically per iteration."""
    return torch.tanh(c @ c).mul_(0.5).add_(0.5)


def compute_operand(tile: int, device: DeviceLike = None) -> torch.Tensor:
    """The burn loop's carry; shared with the segment loop so a fused
    iteration costs exactly what an atom iteration costs."""
    return torch.eye(tile, dtype=torch.float32, device=resolve(device)) * 0.5


def memory_stream_body(c: torch.Tensor) -> torch.Tensor:
    """One memory-atom iteration: a full read+write pass over the block."""
    return c * 1.0000001


def memory_operand(block_bytes: int,
                   device: DeviceLike = None) -> torch.Tensor:
    """The stream loop's carry (one block); shared with the segment loop
    for the same reason as ``compute_operand``."""
    return torch.ones((block_bytes // 4,), dtype=torch.float32,
                      device=resolve(device))


def _torch_burn(x: torch.Tensor, iters: int) -> torch.Tensor:
    for _ in range(iters):
        x = compute_burn_body(x)
    return x


def _torch_stream(x: torch.Tensor, iters: int) -> torch.Tensor:
    for _ in range(iters):
        x = memory_stream_body(x)
    return x


# ---------------------------------------------------------------------------
# Compute
# ---------------------------------------------------------------------------

class ComputeAtom(Atom):
    resource = "flops"

    def __init__(self, calib: Optional[HostCalibration] = None,
                 tile: int = 256, efficiency: float = 1.0,
                 backend: str = "torch", device: DeviceLike = None):
        """``efficiency``: the paper's loop-rate knob — the profiled
        application's measured efficiency (achieved/peak); the atom burns
        flops/efficiency raw loop flops so wall time matches an application
        running that far below the atom's own (near-peak) rate."""
        self.calib = calib
        self.tile = tile
        self.efficiency = max(efficiency, 1e-6)
        self.backend = check_backend(backend)
        self.device = resolve(device)
        if backend == "cuda":
            # the planned iterations, all of them: the JAX package's pallas
            # backend burns one whatever was planned (repro/core/atoms.py,
            # ComputeAtom._loop_fn_locked) yet reports iters * flops
            self._fn = lambda x, iters: catom_ops.burn(x, iters=iters,
                                                       tile=tile)
        else:
            self._fn = _torch_burn

    def spec(self) -> ComputeSpec:
        return ComputeSpec(tile=self.tile, efficiency=self.efficiency,
                           backend=self.backend)

    def flops_per_iter(self) -> float:
        return 2.0 * self.tile ** 3

    def iters_for(self, flops: float) -> int:
        """Quantize a raw flop amount into burn-loop iterations (the same
        rounding the fused schedule compiler uses for its tables)."""
        return max(int(round(flops / self.flops_per_iter()
                             / self.efficiency)), 0)

    def plan(self, flops: float) -> Plan:
        iters = self.iters_for(flops)
        if iters == 0:
            return Plan.noop()
        # Key on the quantized amount (iters), not the raw flops: amounts
        # that round to the same loop count are the same plan, and the plan
        # reports the amount it actually emulates so sharers agree.
        key = ("compute", self.backend, self.tile, self.efficiency, iters)
        return self._cached(key, lambda: self._build_plan(iters))

    def _build_plan(self, iters: int) -> Plan:
        fn = self._fn
        x = compute_operand(self.tile, self.device)
        emulated = iters * self.flops_per_iter() * self.efficiency
        return Plan(lambda: fn(x, iters), emulated)

    def seconds(self, flops: float, hw: HardwareSpec) -> float:
        peak = hw.peak_flops * hw.flops_derate
        return flops / peak if peak else 0.0


# ---------------------------------------------------------------------------
# Memory
# ---------------------------------------------------------------------------

class MemoryAtom(Atom):
    resource = "hbm_bytes"

    def __init__(self, calib: Optional[HostCalibration] = None,
                 block_bytes: int = 1 << 24, backend: str = "torch",
                 device: DeviceLike = None):
        self.calib = calib
        self.block_bytes = block_bytes
        self.backend = check_backend(backend)
        self.device = resolve(device)
        if backend == "cuda":
            self._fn = lambda x, iters: matom_ops.stream(
                x, iters=iters, block_bytes=block_bytes)
        else:
            self._fn = _torch_stream

    def spec(self) -> MemorySpec:
        return MemorySpec(block_bytes=self.block_bytes, backend=self.backend)

    def bytes_per_iter(self) -> float:
        return 2.0 * self.block_bytes              # read + write per pass

    def iters_for(self, nbytes: float) -> int:
        """Quantize a byte amount into stream-loop iterations (shared with
        the fused schedule compiler's tables)."""
        return max(int(round(nbytes / self.bytes_per_iter())), 0)

    def plan(self, nbytes: float) -> Plan:
        iters = self.iters_for(nbytes)
        if iters == 0:
            return Plan.noop()
        key = ("memory", self.backend, self.block_bytes, iters)
        return self._cached(key, lambda: self._build_plan(iters))

    def _build_plan(self, iters: int) -> Plan:
        fn = self._fn
        x = memory_operand(self.block_bytes, self.device)
        return Plan(lambda: fn(x, iters), iters * self.bytes_per_iter())

    def seconds(self, nbytes: float, hw: HardwareSpec) -> float:
        bw = hw.hbm_bw * hw.hbm_derate
        return nbytes / bw if bw else 0.0


# ---------------------------------------------------------------------------
# Storage
# ---------------------------------------------------------------------------

class StorageAtom(Atom):
    resource = "storage_bytes"

    def __init__(self, calib: Optional[HostCalibration] = None,
                 block_bytes: int = 1 << 20, directory: Optional[str] = None):
        self.calib = calib
        self.block_bytes = block_bytes
        self.dir = directory or tempfile.gettempdir()
        self._buf = os.urandom(block_bytes)
        self._paths: set = set()

    def spec(self) -> StorageSpec:
        return StorageSpec(block_bytes=self.block_bytes)

    def _path(self) -> str:
        # Keyed by planning thread so concurrent workers never write the
        # same scratch file; one worker reuses its file across samples.
        # Tracked so runs can clean up (thread idents churn per pool).
        p = os.path.join(self.dir, f"synapse_atom_{os.getpid()}_"
                                   f"{threading.get_ident()}.bin")
        self._paths.add(p)
        return p

    def cleanup(self) -> None:
        """Remove scratch files created by past plans."""
        while self._paths:
            p = self._paths.pop()
            try:
                os.unlink(p)
            except OSError:
                pass

    def plan_write(self, nbytes: float) -> Plan:
        blocks = max(int(nbytes // self.block_bytes), 0)
        if blocks == 0:
            return Plan.noop()
        path = self._path()

        def launch():
            with open(path, "wb") as f:
                for _ in range(blocks):
                    f.write(self._buf)
                f.flush()
                os.fsync(f.fileno())
            return None
        return Plan(launch, blocks * self.block_bytes)

    def plan_read(self, nbytes: float, precreate: bool = True) -> Plan:
        blocks = max(int(nbytes // self.block_bytes), 0)
        if blocks == 0:
            return Plan.noop()
        path = self._path()
        # Populate the scratch file at *plan* time: the timed read leg must
        # not pay a hidden write on first use (and an empty file would spin
        # the wrap-around read loop forever).  Callers whose sample carries
        # a write leg that runs first pass ``precreate=False`` — that write
        # populates the file and plan-time bytes would be wasted I/O.
        def populate():
            with open(path, "wb") as f:
                for _ in range(blocks):
                    f.write(self._buf)

        if precreate and (not os.path.exists(path)
                          or os.path.getsize(path) == 0):
            populate()

        def launch():
            # the scratch file can vanish between plan and launch (another
            # replay's cleanup()); re-populate rather than fail the leg
            if not os.path.exists(path) or os.path.getsize(path) == 0:
                populate()
            done = 0
            with open(path, "rb") as f:
                while done < blocks * self.block_bytes:
                    chunk = f.read(self.block_bytes)
                    if not chunk:
                        f.seek(0)
                        continue
                    done += len(chunk)
            return None
        return Plan(launch, blocks * self.block_bytes)

    def plan(self, nbytes: float):
        return self.plan_write(nbytes)

    def seconds(self, nbytes: float, hw: HardwareSpec) -> float:
        if self.calib is None:
            return 0.0
        return nbytes / self.calib.storage_write_bps

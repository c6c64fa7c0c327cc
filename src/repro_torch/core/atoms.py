"""Emulation atoms: small self-contained consumers of one resource type.

Paper §IV-B, on a CUDA card:

  * ComputeAtom    — float32 matmul burn loop.  ``efficiency`` < 1
                     throttles it exactly like the paper's loop-rate knob
                     (emulate an app running below peak).  Backends:
                     ``"torch"`` (a loop of PyTorch ops) or ``"cuda"``, the
                     hand-written kernel in ``repro_torch.kernels.compute_atom``.
  * MemoryAtom     — streams a target byte count through device memory:
                     in-place passes over a ring of blocks several times
                     the L2's size, made once per atom (``"cuda"``: the
                     ring entry of the kernel in
                     ``repro_torch.kernels.memory_atom``, one launch a
                     call; ``"torch"``: one in-place ``mul_`` a pass).
  * CollectiveAtom — moves an exact wire-byte count over a mesh axis with
                     all-reduce, all-gather or collective-permute (the
                     paper's "planned" network atom).  A mesh's shards all
                     live on one device (``repro_torch.launch.mesh``), so
                     the bytes move through that device's memory, not over
                     a link.  Backends: ``"torch"`` (the plain version) or
                     ``"cuda"``, the hand-written kernel in
                     ``repro_torch.kernels.collective``.
  * StorageAtom    — block-wise file write/read (libc read/write, unchanged
                     from the paper; block size is the tunable the paper
                     discusses in §IV-E.3).

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
from repro_torch.kernels.collective import ops as coll_ops
from repro_torch.kernels.collective import ref as coll_ref
from repro_torch.kernels.compute_atom import ops as catom_ops
from repro_torch.kernels.memory_atom.kernel import Ring, stream_ring
from repro_torch.kernels.memory_atom.ref import SCALE as STREAM_SCALE

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


@dataclass(frozen=True)
class CollectiveSpec:
    axis: Optional[str] = None           # None: the mesh's last axis
    kind: str = "all-reduce"

    def build(self, mesh, backend: str = "torch") -> "CollectiveAtom":
        return CollectiveAtom(mesh, axis=self.axis, kind=self.kind,
                              backend=backend)

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


def memory_stream_body(ring: Ring, p: int) -> torch.Tensor:
    """One memory-atom iteration: pass ``p`` of ``ring``, a full read+write
    pass in place over its slot ``p % slots``.  No pass touched that slot
    for ``slots - 1`` passes, so on a card it reads device memory, not L2
    (on the CPU the ring has one slot: the chained stream)."""
    return ring.slot(p).mul_(STREAM_SCALE)


def memory_operand(block_bytes: int, device: DeviceLike = None) -> Ring:
    """The stream loop's ring, the same ring the ``"cuda"`` kernel streams;
    shared with the segment loop for the same reason as
    ``compute_operand``."""
    return Ring(block_bytes, resolve(device))


def _torch_burn(x: torch.Tensor, iters: int) -> torch.Tensor:
    for _ in range(iters):
        x = compute_burn_body(x)
    return x


def _torch_stream(ring: Ring, iters: int) -> torch.Tensor:
    """``iters`` >= 1 passes over ``ring``, numbered on from its counter;
    returns the block the last pass wrote."""
    start = ring.claim(iters)
    for p in range(start, start + iters):
        x = memory_stream_body(ring, p)
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
        self._ring: Optional[Ring] = None
        self._ring_lock = threading.Lock()

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

    def ring(self) -> Ring:
        """The ring both backends stream, made (and filled) at first use and
        shared by every plan of this atom: a pass streams a block that no
        pass touched for ``slots - 1`` passes, so it reads device memory,
        not L2.  Never re-copied per call, which would be device traffic
        that no profile planned."""
        if self._ring is None:
            with self._ring_lock:
                if self._ring is None:
                    self._ring = memory_operand(self.block_bytes,
                                                self.device)
        return self._ring

    def _build_plan(self, iters: int) -> Plan:
        amount = iters * self.bytes_per_iter()
        ring = self.ring()
        if self.backend == "cuda":
            return Plan(lambda: stream_ring(ring, passes=iters), amount)
        return Plan(lambda: _torch_stream(ring, iters), amount)

    def seconds(self, nbytes: float, hw: HardwareSpec) -> float:
        bw = hw.hbm_bw * hw.hbm_derate
        return nbytes / bw if bw else 0.0


# ---------------------------------------------------------------------------
# Collective (network)
# ---------------------------------------------------------------------------

class CollectiveAtom(Atom):
    resource = "ici_bytes"

    def __init__(self, mesh=None, axis: Optional[str] = None,
                 kind: str = "all-reduce", backend: str = "torch"):
        """``mesh``: a ``repro_torch.launch.mesh.Mesh`` (every shard on
        its one device, where the atom runs); ``axis``: the mesh axis the
        collective runs along (default its last)."""
        self.mesh = mesh
        self.axis = axis or (mesh.axis_names[-1] if mesh is not None
                             else None)
        self.kind = kind
        self.backend = check_backend(backend)
        self._loop_fn: Optional[Callable] = None

    def spec(self) -> CollectiveSpec:
        return CollectiveSpec(axis=self.axis, kind=self.kind)

    def quant(self) -> CollectiveQuant:
        """This atom's fused-segment quantization (needs the mesh)."""
        return CollectiveQuant(n=self.mesh.shape[self.axis], kind=self.kind)

    def loop_operand(self, block_elems: int = COLL_BLOCK_ELEMS
                     ) -> torch.Tensor:
        """The fused segment's collective carry: one fixed block per shard
        of the axis, (n, block_elems), on the mesh's device."""
        n = self.mesh.shape[self.axis]
        return torch.ones((n, block_elems), dtype=torch.float32,
                          device=self.mesh.device)

    def loop_body(self) -> Callable:
        """One fused collective iteration on the ``loop_operand`` carry: a
        shape-invariant collective over the fixed block — unlike
        ``_coll_fn`` (whose all-gather grows its output), the result always
        matches the input shape so a segment can carry it.  Values are kept
        bounded (the all-reduce's sum rescaled by 1/n) because one segment
        may loop thousands of iterations.  The plain version, a new tensor
        a step: the ``"torch"`` runner walks a segment's rows with it, and
        the ``"cuda"`` runner runs the same step inside the segment kernel
        (``csrc/coll.cuh``) instead."""
        if self._loop_fn is None:
            kind = self.kind
            self._loop_fn = lambda x: coll_ref.loop_step(x, dim=0, kind=kind)
        return self._loop_fn

    def _coll_fn(self) -> Callable:
        """The per-sample collective over a plan's shards: the sum over the
        axis (no 1/n), all n blocks gathered, or the shards shifted one
        along the axis."""
        fn = coll_ops.collective if self.backend == "cuda" \
            else coll_ref.collective
        dim, kind = self.mesh.dim(self.axis), self.kind
        return lambda x: fn(x, dim=dim, kind=kind)

    def quantized_wire_bytes(self, n_elems: int) -> float:
        """The wire bytes an ``n_elems``-operand plan actually emulates
        (the ring model applied to the quantized per-chip shard) — note
        tiny amounts clamp UP to one element per shard, so a sub-``4n``-byte
        leg emulates more than it consumes; the emulator reports this as
        ``emulated_ici_bytes`` so predicted-vs-emulated stays honest."""
        n = self.mesh.shape[self.axis]
        factor = collective_factor(self.kind, n)
        return factor * 4.0 * n_elems / n

    def plan(self, wire_bytes: float) -> Plan:
        if self.mesh is None or wire_bytes <= 0:
            return Plan.noop()
        n = self.mesh.shape[self.axis]
        factor = collective_factor(self.kind, n)
        if factor <= 0.0:
            # one shard all-reduces or gathers nothing: no wire to move.
            # The JAX package inverts the ring model through
            # max(factor, 1e-9) here and plans an operand of 2.5e8 floats
            # a wire byte.
            return Plan.noop()
        # invert the ring model on the PER-CHIP shard:
        # wire/chip = factor * shard_bytes  (all-reduce: 2*(n-1)/n)
        shard_bytes = wire_bytes / factor
        n_elems = max(int(shard_bytes / 4) * n, n)
        n_elems = (n_elems // n) * n or n
        # Quantized key: amounts rounding to the same shard size share one
        # plan, and the plan reports the QUANTIZED amount it emulates,
        # never the builder's raw wire_bytes, so every cache sharer agrees
        # on what was moved.  Mesh identity is part of the key, with shard
        # ids where the JAX package has device ids: the same tuple.
        mesh_id = (tuple(sorted(self.mesh.shape.items())),
                   self.mesh.shard_ids)
        key = ("collective", self.kind, self.axis, mesh_id, n_elems)
        return self._cached(key, lambda: self._build_plan(n_elems))

    def _build_plan(self, n_elems: int) -> Plan:
        """A plan over ``n_elems`` float32 along the axis: n_elems / n on
        every shard of the mesh (replicated across its other axes)."""
        fn = self._coll_fn()
        n = self.mesh.shape[self.axis]
        x = torch.ones(tuple(self.mesh.shape.values()) + (n_elems // n,),
                       dtype=torch.float32, device=self.mesh.device)
        return Plan(lambda: fn(x), self.quantized_wire_bytes(n_elems))

    def seconds(self, wire_bytes: float, hw: HardwareSpec) -> float:
        bw = hw.ici_bw * hw.ici_derate
        return wire_bytes / bw if bw else 0.0


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

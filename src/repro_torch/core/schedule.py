"""Fused schedule compiler: whole-profile emulation in O(segments) dispatches.

The per-sample replay loop pays a host round trip per atom per sample with a
blocking sync inside every thunk — the dispatch-overhead trap that dominates
emulation cost at fine granularity (paper §IV-B, Fig. 2: fidelity wants
*finer* samples, the old loop made them *more* expensive).  This module
lowers a collapsed run list into a small number of fused segments instead:

  * contiguous **storage-free** runs are packed into a ``FusedSegment``:
    an int32 iteration table with one row per run (compute-burn iters,
    memory-stream iters, collective iters), quantized exactly like the
    atoms quantize (``ComputeAtom.iters_for`` / ``MemoryAtom.iters_for`` /
    ``CollectiveQuant.iters_for``, applied to the count-scaled run
    amounts).  A segment executes as ONE dispatch with one sync: the
    ``SegmentRunner`` carries the compute tile and the memory block through
    every row in order, so the cross-sample ordering contract holds inside
    it.
  * runs with a storage leg (host I/O worker interleave) stay
    ``BarrierStep``s and replay through the per-sample path, splitting the
    segments around them — exactly where the ordering contract demands a
    real barrier.  ``keep_collectives=True`` lowers wire-byte runs to
    barrier steps too.

The table compiler and the payloads (``detach``/``rehydrate_schedule``) are
the JAX package's, so tables and payloads cross between the two packages
bit-identically.  Wire-byte quantization is a picklable
``CollectiveQuant``; a schedule quantized for a mesh (mesh-bound) replays
its wire rows inside the segment's one dispatch on the replaying
emulator's mesh, and a runner with no mesh refuses it.

Tables are padded to power-of-two lengths with all-zero no-op rows, as
the JAX package pads them (its jit compiles one program per padded
length); the segment kernel skips them on the device.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Union

import numpy as np

from repro_torch.core.atoms import (CollectiveQuant, ComputeAtom,
                                    MemoryAtom, check_backend,
                                    compute_burn_body, compute_operand,
                                    memory_stream_body)
from repro_torch.core.metrics import ResourceVector
from repro_torch.device import DeviceLike, resolve, sync
from repro_torch.kernels.memory_atom.kernel import Ring
from repro_torch.kernels.segment import ops as segment_ops
from repro_torch.kernels.segment.kernel import SegmentRun
from repro_torch.obs import spans


@dataclass
class FusedSegment:
    """Contiguous storage-free runs packed into one dispatch.

    ``table`` row i holds (compute_iters, memory_iters, collective_iters)
    for the i-th run; ``rows`` holds the matching consumed
    ``ResourceVector`` per run, already count-scaled, in profile order
    (the emulator adds them in sequence so consumed totals are
    bit-identical to the per-sample path).  A segment with any nonzero
    collective iters is **mesh-bound**: executing it needs a
    ``SegmentRunner`` whose emulator owns a mesh.  Legacy two-column
    tables (pre-collective payloads, hand-built warmup tables) normalize
    to three columns with a zero wire column.
    """
    table: np.ndarray                     # (n_rows, 3) int32
    rows: List[ResourceVector] = field(default_factory=list)

    def __post_init__(self):
        t = np.asarray(self.table, dtype=np.int32)
        if t.ndim != 2 or t.shape[1] not in (2, 3):
            raise ValueError(f"segment table must be 2-D with 2 or 3 "
                             f"columns, got shape {t.shape}")
        if t.shape[1] == 2:
            t = np.concatenate(
                [t, np.zeros((t.shape[0], 1), dtype=np.int32)], axis=1)
        self.table = t

    @property
    def n_rows(self) -> int:
        return int(self.table.shape[0])

    @property
    def compute_iters(self) -> int:
        return int(self.table[:, 0].sum())

    @property
    def memory_iters(self) -> int:
        return int(self.table[:, 1].sum())

    @property
    def collective_iters(self) -> int:
        return int(self.table[:, 2].sum())

    @property
    def mesh_bound(self) -> bool:
        return self.collective_iters > 0


@dataclass
class BarrierStep:
    """A collapsed run the fused path must replay per-sample: it carries a
    storage leg (I/O worker interleave) or an executable collective."""
    resources: ResourceVector
    count: int = 1


ScheduleStep = Union[FusedSegment, BarrierStep]


@dataclass
class CompiledSchedule:
    """A profile lowered to fused segments split by barrier steps.

    ``collective_quant`` is the wire-byte quantization the tables were
    built with — present whenever wire runs were fused into mesh-bound
    segments, so a replaying emulator can validate that its own mesh
    matches the one the schedule was quantized for.
    """
    steps: List[ScheduleStep] = field(default_factory=list)
    collective_quant: Optional[CollectiveQuant] = None

    def detach(self) -> Dict:
        """Lower this schedule to a plain-data payload (ints, floats, dicts,
        one int32 ndarray per segment) with no references to atoms, meshes
        or device tensors — safe to pickle across a process boundary and
        cheap to ship to fleet workers.  ``rehydrate_schedule`` is the exact
        inverse: resource vectors round-trip bit-identically (float fields
        are copied, never re-derived), which is what lets a process-fleet
        replay report consumed totals equal to an in-process replay."""
        steps = []
        for s in self.steps:
            if isinstance(s, FusedSegment):
                steps.append({"kind": "segment",
                              "table": np.asarray(s.table, dtype=np.int32),
                              "rows": [r.to_dict() for r in s.rows]})
            else:
                steps.append({"kind": "barrier",
                              "resources": s.resources.to_dict(),
                              "count": int(s.count)})
        payload = {"version": 2, "steps": steps}
        if self.collective_quant is not None:
            payload["collective"] = self.collective_quant.to_dict()
        return payload

    @property
    def segments(self) -> List[FusedSegment]:
        return [s for s in self.steps if isinstance(s, FusedSegment)]

    @property
    def barriers(self) -> List[BarrierStep]:
        return [s for s in self.steps if isinstance(s, BarrierStep)]

    @property
    def n_rows(self) -> int:
        return sum(s.n_rows for s in self.segments)

    @property
    def mesh_bound(self) -> bool:
        """True when any segment carries executable collective rows."""
        return any(s.mesh_bound for s in self.segments)

    def describe(self) -> Dict[str, int]:
        return {"n_steps": len(self.steps),
                "n_segments": len(self.segments),
                "n_barriers": len(self.barriers),
                "n_rows": self.n_rows,
                "compute_iters": sum(s.compute_iters for s in self.segments),
                "memory_iters": sum(s.memory_iters for s in self.segments),
                "collective_iters": sum(s.collective_iters
                                        for s in self.segments)}


def rehydrate_schedule(payload: Dict) -> CompiledSchedule:
    """Rebuild a ``CompiledSchedule`` from a ``CompiledSchedule.detach()``
    payload.  Tables and resource vectors come back bit-identical.
    Version-1 payloads (two-column tables, pre-fused-collectives) load
    with a zero wire column."""
    if not isinstance(payload, dict) or payload.get("version") not in (1, 2):
        raise ValueError(f"unsupported schedule payload: "
                         f"{payload.get('version') if isinstance(payload, dict) else payload!r}")
    steps: List[ScheduleStep] = []
    for s in payload["steps"]:
        kind = s.get("kind")
        if kind == "segment":
            steps.append(FusedSegment(
                table=np.asarray(s["table"], dtype=np.int32),
                rows=[ResourceVector.from_dict(r) for r in s["rows"]]))
        elif kind == "barrier":
            steps.append(BarrierStep(
                resources=ResourceVector.from_dict(s["resources"]),
                count=int(s["count"])))
        else:
            raise ValueError(f"unknown schedule step kind {kind!r}")
    quant = (CollectiveQuant.from_dict(payload["collective"])
             if payload.get("collective") is not None else None)
    return CompiledSchedule(steps=steps, collective_quant=quant)


def compile_schedule(runs, *, compute: ComputeAtom, memory: MemoryAtom,
                     collective=None, flops_scale: float = 1.0,
                     mem_scale: float = 1.0, speed: float = 1.0,
                     keep_collectives: Optional[bool] = None,
                     collective_quant: Optional[CollectiveQuant] = None
                     ) -> CompiledSchedule:
    """Lower collapsed (ResourceVector, count) runs into a CompiledSchedule.

    Quantization mirrors the per-sample path exactly: a run is scaled by its
    count first (the legacy fuse semantics for identical consecutive
    samples), then each amount is scaled and quantized by the owning atom's
    ``iters_for``.  Amounts below one iteration lower to a no-op row, same
    as the atoms' zero-iteration plans.

    Runs with wire bytes lower three ways:

      * **fused** (default when a quantization is available): the run
        becomes a segment row whose third column holds collective
        iterations — the whole run executes inside the segment's one
        dispatch, on the replaying emulator's mesh.  The quantization
        comes from ``collective_quant`` if given, else from ``collective``
        when it is mesh-bound; it is recorded on the schedule so a
        replayer on a *different* mesh fails loudly instead of emulating
        skewed wire amounts.
      * **barrier** (``keep_collectives=True``): the run stays a
        ``BarrierStep`` replayed per-sample through ``CollectiveAtom`` —
        the fallback for meshless parents that cannot quantize.
      * **folded** (``keep_collectives=False``, or no quantization
        source): wire bytes are accounted in the row's resources but
        execute nothing — there is no mesh to move them on.
    """
    quant = collective_quant
    if quant is None and collective is not None \
            and getattr(collective, "mesh", None) is not None:
        quant = collective.quant()
    fuse_wire = keep_collectives is None and quant is not None
    steps: List[ScheduleStep] = []
    table_rows: List = []
    vecs: List[ResourceVector] = []

    def flush():
        if table_rows:
            steps.append(FusedSegment(
                table=np.asarray(table_rows, dtype=np.int32).reshape(-1, 3),
                rows=list(vecs)))
            table_rows.clear()
            vecs.clear()

    for r, count in runs:
        has_storage = (r.storage_read_bytes > 0 or r.storage_write_bytes > 0)
        has_collective = bool(keep_collectives) and r.ici_total > 0
        if has_storage or has_collective:
            flush()
            steps.append(BarrierStep(resources=r, count=count))
            continue
        rr = r.scale(count) if count > 1 else r
        ci = compute.iters_for(rr.flops * flops_scale / speed) \
            if rr.flops > 0 else 0
        mi = memory.iters_for(rr.hbm_bytes * mem_scale / speed) \
            if rr.hbm_bytes > 0 else 0
        wi = quant.iters_for(rr.ici_total / speed) \
            if fuse_wire and rr.ici_total > 0 else 0
        table_rows.append((ci, mi, wi))
        vecs.append(rr)
    flush()
    return CompiledSchedule(steps=steps,
                            collective_quant=quant if fuse_wire else None)


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


class SegmentRunner:
    """Executes FusedSegment iteration tables, one dispatch each.

    The counterpart of the JAX package's jitted ``lax.scan``, per backend:

      * ``"cuda"``: ONE launch of the table-driven segment kernel
        (``repro_torch.kernels.segment``, ``csrc/segment.cu``), which reads
        the table from device memory and runs each row's burn iterations
        (the compute atom's cluster burn, carrying y across rows), ring
        passes (the memory atom's ring, its pass counter carried across
        rows and launches) and collective steps (the collective atom's
        loop body on its carry, stepped in place), with a grid barrier
        between rows.  Tiles 64, 128 and 256 only; any other tile raises.
        ``run`` checks the kernel's device counters against the table
        after its sync.
      * ``"torch"``: the padded table is walked on the host and each row
        issues its iterations as PyTorch ops — ``row[0]`` compute-burn
        iterations on the tile, then ``row[1]`` in-place passes over the
        memory atom's ring, then ``row[2]`` steps of the collective atom's
        loop body — with one sync at the end of the segment; on a card every
        iteration is several CUDA launches issued from the host.

    Runs are specialized to the carries a segment actually needs — a
    compute-only segment does not touch the (potentially tens-of-MB)
    memory block, matching the per-sample path where a zero-iteration
    amount plans to a noop.  ``ring`` returns the ring the memory passes
    of either backend stream: the Emulator passes its ``MemoryAtom.ring``,
    so its per-sample plans and its segments share one ring and one pass
    count; a runner built alone streams the ring of a ``MemoryAtom`` of
    its own.  Safe to share across threads: operand init is guarded, the
    burn's operand is read-only, ring passes are numbered under the
    ring's lock (two threads streaming one ring leave values that depend
    on the interleaving, never other amounts), and the ``"cuda"`` wire
    carry, stepped in place by launches that serialize on the stream,
    starts at ones, a fixed point of every kind's step.

    On a mesh of distinct ranks (``launch.world.RankMesh``) no launch on
    this rank's device can take the wire steps: a mesh-bound segment is
    split at its wire rows (``_launch_split``), the rows between them one
    dispatch of either backend, each wire row's steps over the axis's
    process group in between.

    ``collective`` (a mesh-bound ``CollectiveAtom``) supplies the
    per-iteration wire step and its fixed-block carry; without one,
    launching a mesh-bound segment raises — a meshless replayer must
    recompile with ``keep_collectives=True`` instead of silently dropping
    wire work.
    """

    def __init__(self, tile: int = 256, block_bytes: int = 1 << 24,
                 device: DeviceLike = None, backend: str = "torch",
                 ring: Optional[Callable[[], Ring]] = None,
                 collective=None):
        self.tile = tile
        self.block_bytes = block_bytes
        self.device = resolve(device)
        self.backend = check_backend(backend)
        self.collective = collective
        self._lock = threading.Lock()
        self._xc = None
        self._xcoll = None
        self._ring = ring or MemoryAtom(block_bytes=block_bytes,
                                        backend=backend,
                                        device=self.device).ring

    def _compute_operand(self):
        if self._xc is None:
            with self._lock:
                if self._xc is None:
                    self._xc = compute_operand(self.tile, self.device)
        return self._xc

    def set_collective(self, atom) -> None:
        """Swap the collective atom, dropping the collective carry: it lies
        on the OLD atom's mesh."""
        with self._lock:
            self.collective = atom
            self._xcoll = None

    def _coll_operand(self):
        if self._xcoll is None:
            with self._lock:
                if self._xcoll is None:
                    self._xcoll = self.collective.loop_operand()
        return self._xcoll

    @staticmethod
    def _segment(y, ring, w, table: np.ndarray, coll_step=None):
        """Walk ``table`` on the host; ``y`` (the compute carry), ``ring``
        (the memory atom's ring; its passes are numbered on from its
        counter) or ``w`` (the collective carry, stepped by ``coll_step``)
        is None when no row uses it.  Returns the carries, the ring's as
        the block its last pass wrote."""
        slot = None
        for ci, mi, wi in table.tolist():
            if y is not None:
                for _ in range(ci):
                    y = compute_burn_body(y)
            if ring is not None and mi:
                start = ring.claim(mi)
                for p in range(start, start + mi):
                    slot = memory_stream_body(ring, p)
            if w is not None:
                for _ in range(wi):
                    w = coll_step(w)
        return y, slot, w

    def launch(self, segment: FusedSegment):
        """Issue the whole segment asynchronously; returns the unsynced
        ``SegmentRun`` — ``y``, the compute carry, ``slot``, the memory
        carry, and ``w``, the collective carry, each None when no row uses
        it; wait for them with ``repro_torch.device.sync``, then
        ``settle()`` it — or ``None`` when every row quantized to zero
        iterations (nothing to dispatch).  Span ``segment.launch``; while
        tracing, the ``"cuda"`` backend launches the timed kernel."""
        with spans.span("segment.launch"):
            with_c = segment.compute_iters > 0
            with_m = segment.memory_iters > 0
            with_coll = segment.collective_iters > 0
            if not (with_c or with_m or with_coll):
                return None
            if with_coll and (self.collective is None
                              or self.collective.mesh is None):
                raise RuntimeError(
                    "mesh-bound segment (collective iterations in its table) "
                    "but this runner has no mesh-bound CollectiveAtom; "
                    "recompile the schedule with keep_collectives=True to "
                    "replay wire legs per-sample, or give the emulator a mesh")
            if with_coll and not self.collective.mesh.shared:
                return self._launch_split(segment, with_c, with_m)
            padded = _next_pow2(segment.n_rows)
            table = np.zeros((padded, 3), dtype=np.int32)
            table[:segment.n_rows] = segment.table
            w = self._coll_operand() if with_coll else None
            if self.backend == "cuda":
                return segment_ops.segment(
                    table, x=self._compute_operand() if with_c else None,
                    ring=self._ring() if with_m else None, w=w,
                    kind=self.collective.kind if with_coll else "all-reduce",
                    timed=spans.on())
            # wire-only segments skip the (big) compute and memory operands;
            # the ring is the memory atom's, so a fused pass costs what an atom
            # pass costs
            return SegmentRun(*self._segment(
                self._compute_operand() if with_c else None,
                self._ring() if with_m else None, w, table,
                self.collective.loop_body() if with_coll else None))

    def _launch_split(self, segment: FusedSegment, with_c: bool,
                      with_m: bool) -> SegmentRun:
        """A mesh-bound segment on distinct ranks (``RankMesh``), whose
        wire steps no launch on this rank's device can take: split at its
        wire rows.  The burns and passes of the rows up to a wire row (its
        own included) run as one dispatch of this runner's backend (one
        segment kernel launch on ``"cuda"``, synced and its device counts
        settled; the host walk on ``"torch"``), then that row's steps run
        over the axis's group (``RankMesh.loop``).  The burn's
        carry runs on across the dispatches.  Returns the carries, every
        dispatch done and settled."""
        x = self._compute_operand() if with_c else None
        ring = self._ring() if with_m else None
        coll, w = self.collective, self._coll_operand()
        y = slot = None
        rows: List = []

        def dispatch():
            nonlocal y, slot
            table = np.asarray(rows, dtype=np.int32).reshape(-1, 3)
            rows.clear()
            c, m = int(table[:, 0].sum()), int(table[:, 1].sum())
            if not (c or m):
                return
            x_in = (y if y is not None else x) if c else None
            if self.backend == "cuda":
                run = segment_ops.segment(
                    table, x=x_in, ring=ring if m else None)
                sync(run.tensors())
                run.settle()
                y_out, s_out = run.y, run.slot
            else:
                y_out, s_out, _ = self._segment(
                    x_in, ring if m else None, None, table)
            y = y_out if c else y
            slot = s_out if m else slot

        for ci, mi, wi in segment.table.tolist():
            rows.append((ci, mi, 0))
            if wi:
                dispatch()
                w = coll.mesh.loop(w, coll.axis, coll.kind, wi)
        dispatch()
        return SegmentRun(y, slot, w)

    def run(self, segment: FusedSegment) -> bool:
        """Dispatch, sync and settle: the segment's samples are done on
        return.  Returns False when the segment was all-noop (no dispatch
        issued).  Span ``segment.wait`` around the sync and settle; a
        timed launch's burn sums bump its counters ``segment.burn_wait_ns``
        and ``segment.burn_ns``, and its row times go to the span recorder
        after it."""
        run = self.launch(segment)
        if run is None:
            return False
        with spans.span("segment.wait") as sp:
            sync(run.tensors())
            run.settle()
            if sp is not None and run.burn_ns is not None:
                waited, burned = run.burn_ns.tolist()
                sp.count("segment.burn_wait_ns", waited)
                sp.count("segment.burn_ns", burned)
        if run.stamps is not None:
            record_row_times(run.stamps.cpu().numpy(), segment)
        return True


def record_row_times(stamps: np.ndarray, segment: FusedSegment) -> None:
    """The rows of a timed launch that ran (a stamp not 0), each with its
    device nanoseconds (its end less the end of the row before it, the
    first row's from the launch's first stamp, ``stamps[-1]``) and the
    operations and bytes ``segment.rows`` planned for it, to the span
    recorder.  A table with no planned rows (a warm-up's) records nothing."""
    ran = np.flatnonzero(stamps[:segment.n_rows])
    if not len(ran) or len(segment.rows) != segment.n_rows:
        return
    ends = stamps[ran]
    ns = np.diff(ends, prepend=stamps[-1])
    spans.row_times(ns.tolist(), [segment.rows[i].flops for i in ran],
                    [segment.rows[i].hbm_bytes for i in ran])

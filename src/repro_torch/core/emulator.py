"""Sample-ordered emulation driver (paper §IV-B, §IV-D).

Replays a SynapseProfile through the atoms: within one sample all resource
types start together (storage on a worker thread, compute+memory dispatched
asynchronously on the device's current stream with ONE sync at the sample
barrier); the next sample starts only when every consumption of the current
sample finished.  Ordering across samples is the fidelity contract that
implicitly preserves inter-resource dependencies; concurrency inside a
sample may *speed up* emulation relative to the original serial execution,
shrinking with finer sampling (paper Fig. 2).

Two execution paths share that contract:

  * **fused** (default): the schedule compiler
    (``repro_torch.core.schedule``) packs contiguous storage-free runs into
    iteration tables, each executed as ONE segment dispatch with one sync,
    so an M-sample profile costs O(storage-segment boundaries) dispatches
    instead of O(M × atoms); sample ordering is preserved inside the
    segment.  On the ``"cuda"`` backend a segment is one launch of the
    table-driven segment kernel (compute tiles 64, 128 and 256, the burn's
    cluster tiles); on ``"torch"`` the table is walked on the host issuing
    PyTorch ops.  Runs with a storage leg replay per-sample between
    segments (the I/O interleave is the point of the barrier).
  * **per-sample** (``fused=False``, or ``"cuda"`` at any other tile): one
    plan per atom per collapsed run.  Identical consecutive samples (a
    layer scan) are planned once and executed as a single scaled
    consumption.

Both paths consume the profile's resource vectors in the same order with
the same count-scaling, so reported ``consumed`` totals are bit-identical
to each other and to the JAX package's.  Wire bytes execute when the
emulator owns a mesh (``Emulator(mesh=...)``, ``attach_collective``): per
sample through the collective atom, fused as the segment's wire rows; a
meshless emulator accounts them without moving them.  A mesh's shards all
live on the emulator's device (``repro_torch.launch.mesh``), or, on a
``RankMesh`` (``repro_torch.launch.world``), this rank's shard does and
the wire bytes move over the axis's process group: per sample and
between the segment's launches, split at its wire rows.
``EmulationReport`` and ``FleetReport`` serialize exactly as the JAX
package's do, so reports cross between the two.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor
from concurrent.futures import wait as futures_wait
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional

from repro_torch.core.atoms import (CollectiveAtom, CollectiveSpec,
                                    ComputeAtom, ComputeSpec, MemoryAtom,
                                    MemorySpec, PlanCache, StorageAtom,
                                    StorageSpec, check_backend)
from repro_torch.core.calibrate import HostCalibration, calibrate
from repro_torch.core.metrics import ResourceVector, Sample, SynapseProfile
from repro_torch.core.schedule import (CompiledSchedule, FusedSegment,
                                       SegmentRunner, compile_schedule)
from repro_torch.device import DeviceLike, resolve, same_device, sync
from repro_torch.kernels.segment.kernel import TILES as SEGMENT_TILES
from repro_torch.obs import spans

#: fleet backends ``emulate_many``/``run_fleet`` accept (see
#: ``repro_torch.fleet``)
VALID_EXECUTORS = ("thread", "process", "remote")


class _Unset:
    """Sentinel type for 'legacy fleet kwarg not passed', so explicitly
    passed defaults fold into a ``FleetConfig`` (with the deprecation
    warning) while silence does not.  Lives here rather than in
    ``repro_torch.fleet.config`` so ``emulate_many`` can use it in its
    signature without a core→fleet module-level import."""

    def __repr__(self) -> str:  # pragma: no cover - repr only
        return "<unset>"


UNSET = _Unset()

@dataclass
class EmulationReport:
    command: str
    ttc_s: float
    n_samples: int
    consumed: ResourceVector
    per_sample_s: List[float] = field(default_factory=list)
    planned: Optional[ResourceVector] = None
    mode: str = "per_sample"             # "fused" | "per_sample"
    n_dispatches: int = 0                # device dispatches issued
    #: executed wire legs (fused rows / barrier launches), counted the same
    #: on every path — fused, barrier fallback, and fleet workers — for
    #: legs of at least one quantization iteration.  Below that the paths
    #: quantize at different granularities and honestly diverge: a fused
    #: row rounds sub-half-block legs to a no-op (like compute/memory
    #: rows), while CollectiveAtom.plan clamps up to one element per shard
    #: (tests/test_collectives_fused.py pins both).
    n_collective_dispatches: int = 0
    #: wire bytes actually moved after quantization — tiny legs clamp UP
    #: (CollectiveAtom pads sub-4n-byte amounts to one element per shard),
    #: so this can exceed consumed.ici_total; comparing predicted vs
    #: emulated must use this, not the profile amount
    emulated_ici_bytes: float = 0.0

    def summary(self) -> Dict:
        return {"command": self.command, "ttc_s": self.ttc_s,
                "n_samples": self.n_samples,
                "mode": self.mode, "n_dispatches": self.n_dispatches,
                "n_collective_dispatches": self.n_collective_dispatches,
                "flops": self.consumed.flops,
                "hbm_bytes": self.consumed.hbm_bytes,
                "ici_bytes": self.consumed.ici_total,
                "emulated_ici_bytes": self.emulated_ici_bytes,
                "storage_read_bytes": self.consumed.storage_read_bytes,
                "storage_write_bytes": self.consumed.storage_write_bytes}

    def to_dict(self) -> Dict:
        """Lossless JSON-able form (``from_dict`` round-trips it)."""
        return {"command": self.command, "ttc_s": self.ttc_s,
                "n_samples": self.n_samples,
                "consumed": self.consumed.to_dict(),
                "per_sample_s": list(self.per_sample_s),
                "planned": (None if self.planned is None
                            else self.planned.to_dict()),
                "mode": self.mode, "n_dispatches": self.n_dispatches,
                "n_collective_dispatches": self.n_collective_dispatches,
                "emulated_ici_bytes": self.emulated_ici_bytes}

    @classmethod
    def from_dict(cls, d: Dict) -> "EmulationReport":
        return cls(command=d["command"], ttc_s=d["ttc_s"],
                   n_samples=d["n_samples"],
                   consumed=ResourceVector.from_dict(d["consumed"]),
                   per_sample_s=list(d.get("per_sample_s", ())),
                   planned=(None if d.get("planned") is None
                            else ResourceVector.from_dict(d["planned"])),
                   mode=d.get("mode", "per_sample"),
                   n_dispatches=d.get("n_dispatches", 0),
                   n_collective_dispatches=d.get(
                       "n_collective_dispatches", 0),
                   emulated_ici_bytes=d.get("emulated_ici_bytes", 0.0))


@dataclass
class FleetReport:
    """Result of a fleet run (``Emulator.emulate_many``): K profiles
    replayed concurrently.  It serializes as the JAX package's does, so
    reports written by either package's fleets load in the other.

    ``max_workers`` is the *effective* pool size (requested workers capped
    at the number of profiles, so tiny fleets don't spawn idle threads; an
    autoscaled fleet reports its ceiling).  ``totals``/``n_samples``/
    ``n_replayed`` are aggregates folded in bundle-index order as reports
    complete — they are the whole result in ``collect="totals"`` mode,
    where ``reports`` stays empty so coordinator memory is bounded by the
    compile-ahead window, not the stream length.  ``scaling`` carries the
    elasticity record of the run (scale_ups/scale_downs/peak_workers/
    peak_queue_depth/peak_window) when the executor streams through
    ``FleetBase``.  ``recovery`` carries the fault-recovery accounting of
    the run (worker_deaths/hung_reaped/requeued/requeue_latency_s/
    lost_replay_s/mttr_s/skipped/speculative_dispatches/speculative_wins/
    heartbeats) — what every fault cost, not just that recovery happened.
    ``obs`` is the observability snapshot (``repro_torch.obs``): the merged
    flight-recorder timeline (bounded), drop accounting, and a metrics
    snapshot — populated by the ``FleetBase`` executors.
    ``dag`` is the critical-path accounting of a dependency-structured
    run (``critical_path_s``/``makespan_s``/``sum_work_s``/
    ``parallelism``/``critical_nodes``/per-node ``slack_s`` — see
    ``repro_torch.fleet.dag.critical_path``); empty for linear runs.
    """
    reports: List[EmulationReport]
    wall_s: float                        # concurrent fleet wall time
    serial_s: float                      # sum of per-profile TTCs
    max_workers: int
    cache_stats: Dict[str, int] = field(default_factory=dict)
    totals: Optional[ResourceVector] = None
    n_samples: int = 0                   # profile samples replayed
    n_replayed: int = 0                  # profiles replayed (any collect=)
    scaling: Dict[str, int] = field(default_factory=dict)
    recovery: Dict = field(default_factory=dict)
    obs: Dict = field(default_factory=dict)
    dag: Dict = field(default_factory=dict)

    @property
    def n_profiles(self) -> int:
        return self.n_replayed or len(self.reports)

    @property
    def speedup(self) -> float:
        """Estimated concurrency win: sum of per-profile TTCs over fleet
        wall time.  Per-profile TTCs are measured *under* concurrent
        contention, so on a saturated host this over-states the true
        back-to-back-vs-fleet ratio; ``bench_scenarios`` measures real
        serial replay separately for the honest number."""
        return self.serial_s / self.wall_s if self.wall_s else 0.0

    def summary(self) -> Dict:
        out = {"n_profiles": self.n_profiles, "wall_s": self.wall_s,
               "serial_s": self.serial_s, "speedup": self.speedup,
               "max_workers": self.max_workers, **self.cache_stats}
        if self.n_samples:
            out["n_samples"] = self.n_samples
        if self.totals is not None:
            out["total_flops"] = self.totals.flops
            out["total_hbm_bytes"] = self.totals.hbm_bytes
            out["total_ici_bytes"] = self.totals.ici_total
        if self.scaling:
            out["scaling"] = dict(self.scaling)
        if self.recovery:
            out["recovery"] = dict(self.recovery)
        if self.dag:
            out["critical_path_s"] = self.dag.get("critical_path_s")
            out["makespan_s"] = self.dag.get("makespan_s")
            out["parallelism"] = self.dag.get("parallelism")
        return out

    #: schema version of ``to_json``; bump on any breaking field change
    SCHEMA = 1

    def to_json(self, *, reports: bool = True) -> Dict:
        """Stable JSON-able form with a schema version field.

        Everything round-trips through ``from_json`` — scaling, recovery
        (fault_events tuples become lists, as JSON requires), the obs
        snapshot, and (unless ``reports=False``, the bounded-memory
        service mode) the per-profile reports.
        """
        rec = dict(self.recovery)
        if "fault_events" in rec:
            rec["fault_events"] = [list(fe) for fe in rec["fault_events"]]
        dag = dict(self.dag)
        if "slack_s" in dag:
            # JSON object keys are strings; from_json restores the ints
            dag["slack_s"] = {str(k): v for k, v in dag["slack_s"].items()}
        return {
            "schema": self.SCHEMA,
            "reports": ([r.to_dict() for r in self.reports]
                        if reports else []),
            "wall_s": self.wall_s, "serial_s": self.serial_s,
            "max_workers": self.max_workers,
            "cache_stats": dict(self.cache_stats),
            "totals": (None if self.totals is None
                       else self.totals.to_dict()),
            "n_samples": self.n_samples, "n_replayed": self.n_replayed,
            "scaling": dict(self.scaling), "recovery": rec,
            "obs": self.obs, "dag": dag,
        }

    @classmethod
    def from_json(cls, d: Dict) -> "FleetReport":
        schema = d.get("schema")
        if schema != cls.SCHEMA:
            raise ValueError(
                f"FleetReport schema {schema!r} is not supported "
                f"(this build reads schema {cls.SCHEMA})")
        rec = dict(d.get("recovery", {}))
        if "fault_events" in rec:
            rec["fault_events"] = [tuple(fe) for fe in rec["fault_events"]]
        dag = dict(d.get("dag", {}))
        if "slack_s" in dag:
            dag["slack_s"] = {int(k): v for k, v in dag["slack_s"].items()}
        return cls(
            reports=[EmulationReport.from_dict(r)
                     for r in d.get("reports", ())],
            wall_s=d["wall_s"], serial_s=d["serial_s"],
            max_workers=d["max_workers"],
            cache_stats=dict(d.get("cache_stats", {})),
            totals=(None if d.get("totals") is None
                    else ResourceVector.from_dict(d["totals"])),
            n_samples=d.get("n_samples", 0),
            n_replayed=d.get("n_replayed", 0),
            scaling=dict(d.get("scaling", {})), recovery=rec,
            obs=dict(d.get("obs", {})), dag=dag)


class ReportFold:
    """Order-stable aggregate folder for streamed fleet results.

    Workers complete bundles in whatever order the fleet's load (and any
    autoscaling) dictates, but float summation is not associative-in-
    practice: folding ``consumed`` totals in completion order would make
    the aggregate depend on pool size and scale events.  ``ReportFold``
    buffers out-of-order arrivals and folds strictly in bundle-index
    order, so the aggregate totals of a streamed, autoscaled fleet are
    bit-identical to a fixed-size (or fully materialized) run over the
    same profiles.  The reorder buffer is bounded by the compile-ahead
    window: index ``i`` can only be outstanding while it is inside the
    window, so at most ``window`` reports are ever buffered.

    ``keep_reports=False`` (``collect="totals"``) drops each report after
    folding — the bounded-coordinator-memory soak mode.
    """

    def __init__(self, keep_reports: bool = True):
        self.keep_reports = keep_reports
        self.reports: List[EmulationReport] = []
        self.totals = ResourceVector()
        self.serial_s = 0.0
        self.n_done = 0
        self.n_skipped = 0
        self.n_skipped_ancestor = 0
        self._next = 0
        self._pending: Dict[int, EmulationReport] = {}
        self._holes: set = set()

    def add(self, idx: int, report: EmulationReport) -> None:
        self._pending[idx] = report
        self._drain()

    def skip(self, idx: int, *, ancestor: bool = False) -> None:
        """Index ``idx`` will never arrive (degraded-mode skip): fold past
        the hole so later indices still aggregate in order — without this
        one skipped bundle would stall the fold and buffer the rest of the
        stream.  ``ancestor=True`` marks a *cascade* hole — a bundle
        skipped because an ancestor in its dependency chain was, not
        because it failed itself — tallied separately in
        ``n_skipped_ancestor`` (always also counted in ``n_skipped``)."""
        self.n_skipped += 1
        if ancestor:
            self.n_skipped_ancestor += 1
        self._holes.add(idx)
        self._drain()

    def _drain(self) -> None:
        while True:
            if self._next in self._holes:
                self._holes.discard(self._next)
                self._next += 1
                continue
            if self._next not in self._pending:
                break
            rep = self._pending.pop(self._next)
            self._next += 1
            self.totals = self.totals.add(rep.consumed)
            self.serial_s += rep.ttc_s
            self.n_done += 1
            if self.keep_reports:
                self.reports.append(rep)


@dataclass(frozen=True)
class EmulatorSpec:
    """Picklable recipe for an ``Emulator``: calibration + atom configs.

    ``build()`` reconstructs an equivalent emulator anywhere — same
    quantization (tile/block sizes), same efficiency/speed knobs, and the
    *parent's* calibration, so a rebuilt emulator neither re-calibrates nor
    drifts from the emulator that compiled its schedules.  ``mesh`` (a live
    ``repro_torch.launch.mesh.Mesh``, built on the destination's own
    device) attaches a CollectiveAtom per the collective spec.
    """
    calib: HostCalibration
    compute: ComputeSpec = ComputeSpec()
    memory: MemorySpec = MemorySpec()
    storage: StorageSpec = StorageSpec()
    collective: Optional[CollectiveSpec] = None
    speed: float = 1.0

    def build(self, mesh=None, device: DeviceLike = None) -> "Emulator":
        em = Emulator(calib=self.calib, backend=self.compute.backend,
                      compute_tile=self.compute.tile,
                      mem_block=self.memory.block_bytes,
                      storage_block=self.storage.block_bytes,
                      efficiency=self.compute.efficiency, speed=self.speed,
                      device=device)
        if mesh is not None:
            em.attach_collective((self.collective or CollectiveSpec()).build(
                mesh, backend=em.compute.backend))
        return em


class Emulator:
    def __init__(self, calib: Optional[HostCalibration] = None, mesh=None,
                 backend: str = "torch", compute_tile: int = 256,
                 mem_block: int = 1 << 24, storage_block: int = 1 << 20,
                 efficiency: float = 1.0, speed: float = 1.0,
                 plan_cache: Optional[PlanCache] = None,
                 device: DeviceLike = None):
        """``backend``: ``"torch"`` (PyTorch ops) or ``"cuda"`` (the
        hand-written kernels: fused through the segment kernel at compute
        tiles 64, 128 and 256, per sample at others); ``efficiency``:
        paper's CPU-efficiency knob (see ComputeAtom); ``speed`` scales
        resource amounts (emulate faster/slower hosts); ``plan_cache``:
        share planned atoms across emulators of one device; ``device``:
        where the atoms run (``"cuda"`` unless named; raises if absent);
        ``mesh``: a ``repro_torch.launch.mesh.Mesh`` on that device, whose
        last axis the collective atom moves wire bytes along."""
        self.device = resolve(device)
        check_backend(backend)
        self.calib = calib or calibrate(device=self.device)
        self.compute = ComputeAtom(self.calib, tile=compute_tile,
                                   efficiency=efficiency, backend=backend,
                                   device=self.device)
        self.memory = MemoryAtom(self.calib, block_bytes=mem_block,
                                 backend=backend, device=self.device)
        self.storage = StorageAtom(self.calib, block_bytes=storage_block)
        self.collective = None
        self.speed = speed
        self.plan_cache = None
        self._fleet_lock = threading.Lock()
        # the segment kernel burns at the compute atom's cluster tiles only
        self._fusable = backend == "torch" or compute_tile in SEGMENT_TILES
        self._segments = SegmentRunner(tile=compute_tile,
                                       block_bytes=mem_block,
                                       device=self.device, backend=backend,
                                       ring=self.memory.ring)
        if mesh is not None:
            self.attach_collective(CollectiveAtom(mesh, backend=backend))
        if plan_cache is not None:
            self.set_plan_cache(plan_cache)

    def set_plan_cache(self, cache: Optional[PlanCache]) -> None:
        """Route compute/memory/collective plans through a shared cache
        (``None`` detaches it — plans go back to per-call construction)."""
        self.plan_cache = cache
        self.compute.cache = cache
        self.memory.cache = cache
        if self.collective is not None:
            self.collective.cache = cache

    def attach_collective(self, atom: CollectiveAtom) -> None:
        """Install a (mesh-bound) collective atom after construction,
        keeping the segment runner's collective carry and the plan cache
        routing in sync — ``EmulatorSpec.build`` uses this to give fleet
        workers their per-worker mesh.  The mesh's shards must live on
        this emulator's device."""
        if atom.mesh is not None and not same_device(atom.mesh.device,
                                                     self.device):
            raise ValueError(
                f"the mesh's shards live on {atom.mesh.device} but this "
                f"emulator runs on {self.device}: build the mesh on the "
                "emulator's device")
        self.collective = atom
        self._segments.set_collective(atom)
        if self.plan_cache is not None:
            atom.cache = self.plan_cache

    def spec(self) -> EmulatorSpec:
        """This emulator's picklable recipe (see ``EmulatorSpec``)."""
        return EmulatorSpec(
            calib=self.calib, compute=self.compute.spec(),
            memory=self.memory.spec(), storage=self.storage.spec(),
            collective=(self.collective.spec()
                        if self.collective is not None else None),
            speed=self.speed)

    def compile(self, profile: SynapseProfile, *, flops_scale: float = 1.0,
                mem_scale: float = 1.0,
                keep_collectives: Optional[bool] = None,
                mesh_spec=None) -> CompiledSchedule:
        """Lower a profile to its fused schedule (inspection / pre-warm /
        detach-and-ship).  ``mesh_spec`` quantizes wire-byte runs into
        mesh-bound segment rows for the mesh the *workers* will build —
        this process needs no mesh of its own.  ``keep_collectives=True``
        is the barrier-step fallback instead: wire runs replay per-sample
        through the replaying emulator's CollectiveAtom."""
        quant = None
        if mesh_spec is not None:
            spec = (self.collective.spec() if self.collective is not None
                    else CollectiveSpec())
            quant = spec.quant_for(mesh_spec)
        return compile_schedule(_collapse(profile.samples),
                                compute=self.compute, memory=self.memory,
                                collective=self.collective,
                                flops_scale=flops_scale,
                                mem_scale=mem_scale, speed=self.speed,
                                keep_collectives=keep_collectives,
                                collective_quant=quant)

    def _plan_sample(self, r: ResourceVector, flops_scale=1.0,
                     storage_scale=1.0, mem_scale=1.0):
        """Plan one sample's device legs as (resource kind, Plan) pairs plus
        its host-side storage plans.  Wire bytes plan a collective only on
        an emulator with a mesh (they are accounted either way)."""
        thunks = []
        if r.flops > 0:
            thunks.append(("flops",
                           self.compute.plan(r.flops * flops_scale / self.speed)))
        if r.hbm_bytes > 0:
            thunks.append(("hbm",
                           self.memory.plan(r.hbm_bytes * mem_scale / self.speed)))
        wire = r.ici_total
        if wire > 0 and self.collective is not None:
            thunks.append(("ici", self.collective.plan(wire / self.speed)))
        storage_thunks = []
        if r.storage_write_bytes > 0:
            storage_thunks.append(self.storage.plan_write(
                r.storage_write_bytes * storage_scale / self.speed))
        if r.storage_read_bytes > 0:
            # the write leg (if any) runs first on the I/O worker and
            # populates the scratch file; plan-time pre-creation would be
            # wasted bytes then
            writes = storage_thunks and storage_thunks[0].amount > 0
            storage_thunks.append(self.storage.plan_read(
                r.storage_read_bytes * storage_scale / self.speed,
                precreate=not writes))
        return thunks, storage_thunks

    def _run_per_sample(self, r: ResourceVector, count: int, flops_scale,
                        storage_scale, mem_scale, consumed, per_sample,
                        verify: bool):
        """Replay one collapsed run the per-sample way; returns the updated
        consumed vector, the number of device dispatches issued, how many
        of those were executable collectives, and the quantized wire bytes
        those collectives emulated.

        Consecutive identical samples with no storage leg execute as a
        single fused consumption (count × amounts): ordering semantics only
        bind *distinct* samples, and per-dispatch overhead would otherwise
        dominate fine-grained (per-layer) profiles.  Device thunks are
        launched asynchronously and synced once at the sample barrier;
        storage overlaps on the I/O worker thread.
        """
        fuse = count > 1 and r.storage_read_bytes == 0 and \
            r.storage_write_bytes == 0
        reps = 1 if fuse else count
        rr = r.scale(count) if fuse else r
        thunks, storage_thunks = self._plan_sample(
            rr, flops_scale, storage_scale, mem_scale)
        dispatches = 0
        coll_dispatches = 0
        emulated_ici = 0.0
        for _ in range(reps):
            t0 = time.perf_counter()

            def io_worker():
                for t in storage_thunks:
                    t()

            th = None
            if storage_thunks:
                th = threading.Thread(target=io_worker)
                th.start()
            tokens = []
            for kind, t in thunks:                  # async device dispatch
                tok = t.launch()
                if tok is not None:                 # noop plans don't count
                    tokens.append(tok)
                    if kind == "ici":
                        coll_dispatches += 1
                        emulated_ici += t.amount    # quantized, see atoms
            dispatches += len(tokens)
            if tokens:
                sync(tokens)                        # one sync per sample
            if th is not None:
                th.join()
            per_sample.append(time.perf_counter() - t0)
            if verify:
                consumed = consumed.add(rr)
        return consumed, dispatches, coll_dispatches, emulated_ici

    def replay(self, sched: CompiledSchedule, *, command: str = "",
               planned: Optional[ResourceVector] = None,
               flops_scale: float = 1.0, storage_scale: float = 1.0,
               mem_scale: float = 1.0, verify: bool = True
               ) -> EmulationReport:
        """Execute an already-compiled schedule (fused path).

        This is the whole fused replay loop, factored out of ``emulate`` so
        a schedule compiled elsewhere — by this package or by the JAX
        package, through ``CompiledSchedule.detach`` — replays with
        identical consumption accounting: segments run as one dispatch
        each — mesh-bound segments execute their wire rows inside that
        same dispatch on this emulator's mesh — and barrier steps replay
        per-sample through this emulator's atoms, including collective
        legs when this emulator owns a mesh.
        """
        if sched.mesh_bound:
            if self.collective is None or self.collective.mesh is None:
                raise RuntimeError(
                    "schedule carries mesh-bound collective segments but "
                    "this emulator owns no mesh; recompile it with "
                    "keep_collectives=True (barrier fallback) or build the "
                    "emulator with a mesh")
            mine = self.collective.quant()
            want = sched.collective_quant
            if want is None:
                raise RuntimeError(
                    "mesh-bound schedule carries no collective_quant — "
                    "its tables cannot be validated against this mesh; "
                    "recompile it (compile_schedule records the quant "
                    "whenever it fuses wire runs)")
            if want != mine:
                raise RuntimeError(
                    f"schedule was quantized for {want} but this "
                    f"emulator's mesh gives {mine}; replaying would emulate "
                    "skewed wire amounts — recompile for this mesh")
        consumed = ResourceVector()
        per_sample: List[float] = []
        dispatches = 0
        coll_dispatches = 0
        emulated_ici = 0.0
        quant = sched.collective_quant
        t_start = time.perf_counter()
        with spans.span("replay"):
            for step in sched.steps:
                if isinstance(step, FusedSegment):
                    t0 = time.perf_counter()
                    dispatched = self._segments.run(step)  # ONE dispatch+sync
                    dt = time.perf_counter() - t0
                    dispatches += int(dispatched)
                    if step.mesh_bound:
                        # one executed wire leg per collective-bearing row —
                        # the same granularity the barrier fallback counts at
                        coll_dispatches += int((step.table[:, 2] > 0).sum())
                        emulated_ici += quant.emulated_bytes(
                            step.collective_iters)
                    # apportion the segment's wall time across its rows so
                    # per_sample_s keeps one entry per executed sample
                    per_sample.extend([dt / step.n_rows] * step.n_rows)
                    if verify:
                        with spans.span("replay.fold"):
                            for rr in step.rows:
                                consumed = consumed.add(rr)
                else:
                    consumed, d, c, e = self._run_per_sample(
                        step.resources, step.count, flops_scale,
                        storage_scale, mem_scale, consumed, per_sample,
                        verify)
                    dispatches += d
                    coll_dispatches += c
                    emulated_ici += e
        ttc = time.perf_counter() - t_start
        return EmulationReport(command=command, ttc_s=ttc,
                               n_samples=len(per_sample), consumed=consumed,
                               per_sample_s=per_sample, planned=planned,
                               mode="fused", n_dispatches=dispatches,
                               n_collective_dispatches=coll_dispatches,
                               emulated_ici_bytes=emulated_ici)

    def emulate(self, profile: SynapseProfile, *, flops_scale: float = 1.0,
                storage_scale: float = 1.0, mem_scale: float = 1.0,
                verify: bool = True, fused: bool = True) -> EmulationReport:
        # spans: the root ``emulate``; ``emulate.collapse``,
        # ``schedule.compile``, ``emulate.totals`` and ``replay`` under it
        with spans.span("emulate") as root:
            with spans.span("emulate.collapse"):
                runs = _collapse(profile.samples)
            if root is not None:
                root.attrs.update(samples=len(profile.samples),
                                  rows=len(runs))
            use_fused = fused and self._fusable
            t_start = time.perf_counter()
            if use_fused:
                with spans.span("schedule.compile"):
                    sched = compile_schedule(runs, compute=self.compute,
                                             memory=self.memory,
                                             collective=self.collective,
                                             flops_scale=flops_scale,
                                             mem_scale=mem_scale,
                                             speed=self.speed)
                with spans.span("emulate.totals"):
                    planned = profile.totals
                rep = self.replay(sched, command=profile.command,
                                  planned=planned,
                                  flops_scale=flops_scale,
                                  storage_scale=storage_scale,
                                  mem_scale=mem_scale, verify=verify)
                rep.ttc_s = time.perf_counter() - t_start   # include compile
                return rep
            consumed = ResourceVector()
            per_sample: List[float] = []
            dispatches = 0
            coll_dispatches = 0
            emulated_ici = 0.0
            for r, count in runs:
                consumed, d, c, e = self._run_per_sample(
                    r, count, flops_scale, storage_scale, mem_scale,
                    consumed, per_sample, verify)
                dispatches += d
                coll_dispatches += c
                emulated_ici += e
            ttc = time.perf_counter() - t_start
            return EmulationReport(command=profile.command, ttc_s=ttc,
                                   n_samples=len(per_sample),
                                   consumed=consumed,
                                   per_sample_s=per_sample,
                                   planned=profile.totals,
                                   mode="per_sample",
                                   n_dispatches=dispatches,
                                   n_collective_dispatches=coll_dispatches,
                                   emulated_ici_bytes=emulated_ici)

    def emulate_many(self, profiles: Iterable[SynapseProfile], *,
                     flops_scale: float = 1.0, storage_scale: float = 1.0,
                     mem_scale: float = 1.0, verify: bool = True,
                     fused: bool = True, config=None,
                     collect: str = "reports",
                     # legacy fleet kwargs: fold into a FleetConfig with a
                     # DeprecationWarning — pass config= instead
                     executor=UNSET, max_workers=UNSET, mesh_spec=UNSET,
                     hosts=UNSET, listen=UNSET, agents=UNSET,
                     timeout=UNSET) -> FleetReport:
        """Fleet mode: replay many profiles concurrently.

        ``profiles`` is any iterable — a list, or a lazy source like
        ``ProfileStore.stream(...)``.  Every executor consumes it as a
        stream: profiles are pulled (and, on processes, compiled to
        bundles) at most ``config.window`` ahead of replay, so the source
        is backpressured by worker throughput and coordinator memory stays
        bounded by the window even when the stream is a production day
        long.  ``collect="totals"`` additionally drops per-profile reports
        after folding them into ``FleetReport.totals``, the bounded-memory
        mode for unbounded streams.

        ``config`` (a ``repro_torch.fleet.FleetConfig``) is the one knob
        surface: ``FleetConfig.thread()`` runs profiles on worker threads
        inside this process, sharing this emulator's atoms through a keyed
        plan cache — identical (atom, amount) plans are built once for the
        whole fleet instead of once per profile.  On the ``"cuda"`` backend
        the threads' kernels share the current CUDA stream, so each
        sample's sync also waits for the other threads' work.
        ``FleetConfig.process(...)`` compiles each profile to a
        ``CompiledSchedule`` here, detaches it to a picklable bundle, and
        ships it to a spawn-based worker-process pool
        (``repro_torch.fleet.ProcessFleet``) where each worker owns its own
        emulator, CUDA context and plan cache on this emulator's device.
        Process pools can be elastic (``autoscale=True``): workers are
        spawned while queued bundles outnumber free slots and retired back
        to ``min_workers`` when the stream drains, with the scale record in
        ``FleetReport.scaling``.  ``FleetConfig.remote(...)`` ships the
        same bundles over framed TCP to host agents
        (``python -m repro_torch.fleet.agent``), whose workers replay on
        this emulator's device too.  With ``mesh=MeshSpec(...)`` every
        process or remote worker builds its own mesh on that device, so
        collective legs *execute* in fleet mode.  See
        ``repro_torch.fleet``.

        ``config.timeout`` bounds each fleet run.  The process and remote
        executors enforce it strictly (the scheduler deadline); the thread
        executor stops *starting* profiles at the deadline and raises, but
        profiles already replaying run to completion — threads can't be
        preempted.

        The robustness knobs (``max_attempts``, ``liveness_timeout``,
        ``speculate``, ``on_failure``, ``chaos``, ``max_respawns``) thread
        straight through to the fleet scheduler; fault accounting comes
        back in ``FleetReport.recovery``.  With ``on_failure="skip"`` the
        run completes degraded instead of raising on a poison profile —
        ``totals`` then cover only the replayed profiles, with the holes
        listed in ``recovery["skipped"]``.

        Each profile replays on exactly one worker, so the per-profile
        sample-ordering contract is intact; ordering *across* profiles is
        deliberately unconstrained (a fleet has no inter-profile
        dependencies) — but aggregate ``totals`` are folded in profile
        order, so they are bit-identical however the fleet is shaped.  A
        sized ``profiles`` caps the pool at ``len(profiles)`` so tiny
        fleets don't spawn idle workers.

        ``profiles`` may also be a ``repro_torch.scenarios.WorkloadDag``
        (anything exposing ``parents_map``): the fleet then honors the
        dependency edges — a node dispatches only after every parent's
        result lands — and the report's ``dag`` dict carries
        critical-path accounting.  DAGs need the process executor (the
        frontier scheduler lives in ``FleetBase.stream``) and
        ``collect="reports"``; both are validated loudly here.
        """
        from repro_torch.fleet.config import FleetConfig
        cfg = FleetConfig.fold(
            config,
            dict(executor=executor, max_workers=max_workers,
                 mesh_spec=mesh_spec, hosts=hosts, listen=listen,
                 agents=agents, timeout=timeout),
            caller="Emulator.emulate_many")
        if collect not in ("reports", "totals"):
            raise ValueError("collect must be 'reports' (keep per-profile "
                             "reports) or 'totals' (fold aggregates only)")
        is_dag = hasattr(profiles, "parents_map")
        if (is_dag or cfg.dag) and cfg.executor == "thread":
            raise ValueError(
                "dependency-structured workloads (WorkloadDag, or "
                "FleetConfig(dag=True)) need executor='process' or "
                "'remote': the frontier scheduler lives in the fleet "
                "executors — the in-process thread pool has no dispatch "
                "gating.  Use FleetConfig.process(...) or .remote(...)")
        cfg.check_collect(collect, dag=is_dag)
        if cfg.executor in ("process", "remote"):
            if not (fused and self._fusable):
                raise ValueError(
                    f"executor={cfg.executor!r} ships compiled schedules "
                    "and requires the fused replay path (fused=True; "
                    "backend='torch', or backend='cuda' at compute tile "
                    f"{', '.join(map(str, SEGMENT_TILES))})")
            if cfg.executor == "remote":
                from repro_torch.fleet.transport.remote import \
                    run_remote_fleet
                return run_remote_fleet(
                    self, profiles, hosts=cfg.hosts, listen=cfg.listen,
                    agents=cfg.agents, mesh_spec=cfg.mesh_spec,
                    flops_scale=flops_scale, storage_scale=storage_scale,
                    mem_scale=mem_scale, verify=verify,
                    timeout=cfg.timeout, window=cfg.window,
                    autoscale=cfg.autoscale, min_workers=cfg.min_workers,
                    max_attempts=cfg.max_attempts,
                    liveness_timeout=cfg.liveness_timeout,
                    speculate=cfg.speculate, on_failure=cfg.on_failure,
                    chaos=cfg.chaos, collect=collect)
            from repro_torch.fleet.executor import run_process_fleet
            return run_process_fleet(self, profiles,
                                     max_workers=cfg.max_workers,
                                     mesh_spec=cfg.mesh_spec,
                                     flops_scale=flops_scale,
                                     storage_scale=storage_scale,
                                     mem_scale=mem_scale, verify=verify,
                                     timeout=cfg.timeout, window=cfg.window,
                                     autoscale=cfg.autoscale,
                                     min_workers=cfg.min_workers,
                                     max_attempts=cfg.max_attempts,
                                     liveness_timeout=cfg.liveness_timeout,
                                     speculate=cfg.speculate,
                                     on_failure=cfg.on_failure,
                                     chaos=cfg.chaos,
                                     max_respawns=cfg.max_respawns,
                                     collect=collect)
        workers = cfg.max_workers
        if hasattr(profiles, "__len__"):
            workers = max(1, min(workers, len(profiles)))
        win = cfg.window if cfg.window is not None else max(2 * workers, 2)
        # One fleet at a time per emulator: the atoms, ephemeral cache
        # attach/detach and scratch-file cleanup are instance state.
        with self._fleet_lock:
            cache = self.plan_cache
            ephemeral = cache is None
            if ephemeral:
                # Scope the auto-created cache to this call: retained plans
                # pin their operand tensors, so a long-lived emulator must
                # not keep accumulating them as a side effect of one fleet
                # replay.
                cache = PlanCache()
                self.set_plan_cache(cache)
            before = cache.stats()
            fold = ReportFold(keep_reports=collect != "totals")
            skipped: List[int] = []
            try:
                t0 = time.perf_counter()
                deadline = time.monotonic() + cfg.timeout
                source = iter(profiles)
                exhausted = False
                next_idx = 0
                n_samples = 0                    # true profile samples
                inflight: Dict = {}              # future -> profile index
                with ThreadPoolExecutor(max_workers=workers) as pool:
                    try:
                        while True:
                            # admission: at most `win` profiles submitted
                            # but unfinished — a lazy source is pulled (and
                            # anything it generates materialized) only as
                            # the pool drains
                            while not exhausted and len(inflight) < win:
                                try:
                                    p = next(source)
                                except StopIteration:
                                    exhausted = True
                                    break
                                n_samples += len(p.samples)
                                f = pool.submit(self.emulate, p,
                                                flops_scale=flops_scale,
                                                storage_scale=storage_scale,
                                                mem_scale=mem_scale,
                                                verify=verify, fused=fused)
                                inflight[f] = next_idx
                                next_idx += 1
                            if not inflight:
                                break
                            left = deadline - time.monotonic()
                            done = futures_wait(
                                list(inflight), timeout=max(0.0, left),
                                return_when=FIRST_COMPLETED).done
                            if not done:
                                raise TimeoutError(
                                    f"fleet run exceeded {cfg.timeout}s "
                                    f"with {len(inflight)} profile(s) "
                                    "unfinished (in-flight thread replays "
                                    "drain before this raises)")
                            for f in done:
                                idx = inflight.pop(f)
                                try:
                                    rep = f.result()
                                except Exception:
                                    # threads share this process, so there
                                    # is no worker to reap or retry against:
                                    # a profile that raises is degraded-mode
                                    # skippable, nothing else
                                    if cfg.on_failure != "skip":
                                        raise
                                    skipped.append(idx)
                                    fold.skip(idx)
                                    continue
                                fold.add(idx, rep)
                    except BaseException:
                        for f in inflight:
                            f.cancel()           # queued ones never start
                        raise
                wall = time.perf_counter() - t0
            finally:
                if ephemeral:
                    self.set_plan_cache(None)
                self.storage.cleanup()   # pool threads churn -> fresh
                                         # scratch files per run
            # report this call's activity, not cache-lifetime totals
            after = cache.stats()
            stats = {k: after[k] - before[k] for k in ("plans_built", "hits")}
            stats["size"] = after["size"]
        recovery = {"skipped": sorted(skipped)} if skipped else {}
        return FleetReport(reports=fold.reports, wall_s=wall,
                           serial_s=fold.serial_s, max_workers=workers,
                           cache_stats=stats, totals=fold.totals,
                           n_samples=n_samples, n_replayed=fold.n_done,
                           recovery=recovery)


def _collapse(samples: List[Sample]):
    """Group consecutive samples with identical resource vectors."""
    runs = []
    for s in samples:
        if runs and _same(runs[-1][0], s.resources):
            runs[-1][1] += 1
        else:
            runs.append([s.resources, 1])
    return [(r, c) for r, c in runs]


def _same(a: ResourceVector, b: ResourceVector) -> bool:
    return (a.flops == b.flops and a.hbm_bytes == b.hbm_bytes and
            a.ici_bytes == b.ici_bytes and
            a.storage_read_bytes == b.storage_read_bytes and
            a.storage_write_bytes == b.storage_write_bytes)

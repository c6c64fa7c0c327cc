"""Fleet executors: replay schedule bundles on pools of remote peers.

Two layers live here.  ``FleetBase`` is the transport-agnostic scheduler:
it owns the pending queue, the one-bundle-per-worker-slot dispatch loop,
the per-bundle attempt budget (a bundle that keeps killing workers is
declared poison instead of looping forever), the run deadline, and the
reap-requeue-refill dance when a peer dies.  It schedules ``Peer``
objects — anything with worker slots that can ``dispatch`` a bundle and
``recv`` a normalized reply — and never touches a pipe or a socket
itself.

The interchange is an *iterator of bundles*, not a list: ``stream()``
pulls from the source only while fewer than ``window`` bundles are
pulled-but-unfinished, so a lazy source (a generator compiling profiles
on the fly, ``ProfileStore.stream`` feeding ``bundle_profile``) is
backpressured by the workers — the coordinator never materializes more
than a window's worth of compiled schedules no matter how long the
stream is.  ``run()`` is the materializing wrapper (list in, ordered
list of reports out) kept for warm-pool callers and tests.

``FleetBase`` also owns admission control and fleet *elasticity*: with
autoscaling enabled, queued bundles outnumbering free slots grows the
pool one peer per scheduler pass (``_scale_up`` — ProcessFleet spawns a
worker, RemoteFleet's open listener admits late joiners), and once the
source is exhausted idle peers are retired back down to the floor
(``_retire``).  Scale events and high-water marks are recorded in
``last_scaling`` and surfaced through ``FleetReport.scaling``.

``ProcessFleet`` is the local instantiation: each peer is one spawn-based
worker process (see ``repro_torch.fleet.worker``) behind a multiprocessing
``Pipe``, with its own CUDA context, emulator and plan cache on the device
its ``WorkerSpec`` names.
``repro_torch.fleet.transport.remote.RemoteFleet`` is the network
instantiation: each peer is a TCP connection to a host agent that fronts
several such worker processes on another machine.  Both inherit the same
scheduling semantics, which is the point — a dead TCP peer is reaped
exactly like a dead process, and its in-flight bundles requeue onto the
survivors.

Scheduling is work-stealing-simple: one in-flight bundle per worker slot,
next bundle to the first slot that frees up, so a straggler profile never
blocks the rest of the fleet.  Only when no peer is left alive (and none
can be refilled) with work still pending does a run raise.

Liveness is layered on top of I/O-error detection: workers and agents
whose spec sets ``heartbeat_s`` send periodic ``("ping",)`` frames, every
received message refreshes the peer's ``last_seen`` watermark, and a peer
that has in-flight work but has been silent past ``liveness_timeout`` is
reaped as *hung* — its bundles requeue exactly like a dead peer's,
instead of stalling the run to the global deadline.  ``speculate=p``
adds per-bundle soft timeouts: once the pending queue is empty, a bundle
in flight past ``p × median`` completion time is re-dispatched to a free
slot and the first result wins (the epoch/attempt machinery already
discards the loser).  Respawn after a death backs off exponentially
(jittered by a seeded, chaos-safe RNG) and a spec that keeps dying trips
``CrashLoopError`` instead of silently burning the respawn budget.
``on_failure="skip"`` turns worker-reported bundle failures and
exhausted attempt budgets into *skipped indices* rather than a raised
stream; either way ``last_recovery`` records what every fault cost
(requeue latency, lost replay work, MTTR, skips, speculation, heartbeat
volume) and surfaces as ``FleetReport.recovery``.

Bundles may carry dependency edges (``ScheduleBundle.parents``: stream
indices of earlier bundles).  ``stream`` then becomes a *frontier*
scheduler: an edged bundle is admitted into the window but enters the
pending queue only when every parent's result has landed, so a
fork-join sink can never race its branches no matter how many slots are
free.  Edges compose with the whole hardening stack — a killed parent
requeues and its children simply stay blocked until the retry lands,
and under ``on_failure="skip"`` a skipped parent *cascades*: every
transitively-blocked descendant is skipped too (reason ``"ancestor"``,
tallied separately in ``last_recovery["skipped_ancestor"]``) instead of
deadlocking the stream.  Edge-free bundles take the exact pre-DAG code
path, so linear streams replay bit-identically.
"""
from __future__ import annotations

import multiprocessing as mp
import statistics
import time
from collections import deque
from multiprocessing import connection as mp_conn
from random import Random
from dataclasses import dataclass
from typing import (Callable, Deque, Dict, Iterable, Iterator, List,
                    Optional, Set, Tuple)

from repro_torch.core.atoms import COLLECTIVE_TODO
from repro_torch.core.emulator import (EmulationReport, Emulator,
                                       FleetReport, ReportFold)
from repro_torch.fleet.bundle import (ScheduleBundle, WorkerSpec,
                                      bundle_parents, bundle_profile)
from repro_torch.fleet.chaos import ChaosPolicy
from repro_torch.fleet.dag import critical_path, validate_parents
from repro_torch.fleet.worker import worker_loop
from repro_torch.obs import clock as obs_clock
from repro_torch.obs.clock import ClockSync
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.recorder import FlightRecorder, ObsFrame

_MAX_ATTEMPTS = 3          # dispatches per bundle before declaring it poison


class PeerGone(Exception):
    """The peer (worker process or remote agent) is dead or unreachable:
    reap it, requeue its in-flight bundles, keep draining on survivors."""


class CrashLoopError(RuntimeError):
    """A peer spec is dying repeatedly within the crash-loop window: the
    spec (not the luck) is the problem — stop respawning and say so
    loudly instead of exhausting ``max_respawns`` in silence."""


@dataclass(frozen=True)
class BundleTiming:
    """Per-bundle lifecycle stamps from one ``stream`` (``time.monotonic``
    clock).  ``queue_s`` is the *total* time the bundle sat in the pending
    queue — its initial wait plus every post-fault requeue wait — while
    ``replay_s`` is measured from the *last* dispatch only, so a chaos
    requeue never inflates the replay figure (the queueing-delay metric a
    serving layer builds on this stays honest under faults).  A skipped
    bundle reports ``ok=False`` with ``replay_s=0.0``; ``dispatched`` is
    ``None`` when the bundle never reached a worker."""

    enqueued: float             # admitted into the pending queue
    dispatched: Optional[float]  # last handed to a worker (None: never)
    done: float                 # result yielded (or bundle skipped)
    queue_s: float              # total pending-queue residency
    replay_s: float             # done - last dispatch (0.0 if skipped)
    attempts: int               # dispatch attempts consumed
    ok: bool                    # False: skipped under on_failure="skip"


class Peer:
    """One schedulable fleet endpoint with ``capacity`` worker slots.

    ``tasks`` is the in-flight set of ``(dispatch epoch, bundle index)``
    pairs — epoch-qualified so a new run re-dispatching an index can never
    collide with a stale entry for the same index.  Entries from a
    *raised* run (stale epoch) stay until their late results arrive: they
    keep the slot occupied — the worker really is still busy — and the
    scheduler recognizes them by epoch, drops their results, and only
    then reuses the slot.  Subclasses translate their wire format into the
    normalized message tuples the scheduler consumes:

      ("ready", info)                 peer finished initializing
      ("ok",    epoch, idx, report)   bundle replayed
      ("retry", epoch, idx, reason)   peer-side worker died; requeue the
                                      bundle (its dispatch attempt stays
                                      counted, so poison budgets hold)
      ("err",   epoch, idx, tb)       bundle failed (idx=None: init died)
      ("ping",)                       heartbeat: refreshes ``last_seen``

    ``last_seen`` is the liveness watermark: the scheduler stamps it on
    every received message (heartbeats included) and on every dispatch
    (handing a peer work restarts its window), and a busy-but-silent
    peer past ``liveness_timeout`` is reaped as hung.
    """

    capacity = 1

    def __init__(self):
        self.tasks: Set[Tuple[int, int]] = set()
        self.ready = False
        self.last_seen = time.monotonic()
        #: flight-recorder track name; transports set the real one
        #: (ProcessFleet: the spawn scope "worker:<n>")
        self.scope = "peer"
        #: per-peer clock-offset estimator, refined by the echo carried
        #: on every ObsFrame this peer ships home
        self.sync = ClockSync()

    @property
    def free_slots(self) -> int:
        return self.capacity - len(self.tasks)

    def epoch_for(self, idx: int) -> Optional[int]:
        """The dispatch epoch of in-flight bundle ``idx`` — for adapters
        whose wire protocol doesn't echo epochs (capacity-1 pipes hold at
        most one entry, so the lookup is unambiguous there)."""
        return next((e for (e, i) in self.tasks if i == idx), None)

    @property
    def alive(self) -> bool:
        """Cheap local liveness; transports without one return True and
        let death surface as ``PeerGone`` on I/O."""
        return True

    @property
    def waitable(self):
        """Object for ``multiprocessing.connection.wait``."""
        raise NotImplementedError

    def dispatch(self, epoch: int, idx: int, bundle: ScheduleBundle) -> None:
        raise NotImplementedError

    def recv(self):
        raise NotImplementedError

    def stop(self) -> None:
        """Best-effort polite shutdown request; never raises."""

    def close(self) -> None:
        """Tear down the endpoint; never raises."""

    def destroy(self) -> None:
        """Tear down a peer known to be *hung*: no grace a wedged
        endpoint will never honor.  Default: same as ``close``."""
        self.close()

    def describe(self) -> str:
        return "fleet peer"


class FleetBase:
    """Transport-agnostic bundle scheduler over a pool of ``Peer``s.

    Subclasses populate ``self._peers`` and may override ``_refill`` (to
    respawn replacements after a death), ``_scale_up`` (to grow the pool
    when autoscaling), ``_extra_waitables`` / ``_handle_extra`` (to
    service non-peer readiness, e.g. accepting new agents mid-run),
    ``_assemble`` (to gate a run on initial pool assembly), and
    ``_warming`` (to gate warmup on a minimum pool size).
    ``worker_deaths`` counts reaped peers across the pool's lifetime;
    ``scale_ups``/``scale_downs`` count elasticity events the same way,
    and ``last_scaling`` holds the most recent stream's high-water marks.
    """

    def __init__(self):
        self._peers: List[Peer] = []
        self._closed = False
        self._epoch = 0
        self.worker_deaths = 0
        self.hung_reaped = 0
        self.scale_ups = 0
        self.scale_downs = 0
        #: elasticity policy; subclasses flip these (ProcessFleet ctor,
        #: RemoteFleet ctor) — base default is a fixed-size pool
        self._autoscale = False
        self._scale_min = 1
        #: high-water marks / event counts of the most recent stream
        self.last_scaling: Dict[str, int] = {}
        #: fault-recovery accounting of the most recent stream
        self.last_recovery: Dict = {}
        #: indices skipped because an *ancestor* was skipped (cascade
        #: holes, not direct poison) — updated live during the stream so
        #: a consumer folding ``(idx, None)`` announcements can classify
        #: each hole the moment it is yielded
        self.last_ancestor_skips: Set[int] = set()
        #: MTTR bookkeeping: death times of faults a refill will repair,
        #: popped when the replacement reports ready (approximate when a
        #: scale-up races an outstanding respawn, exact otherwise)
        self._fault_opened: Deque[float] = deque()
        self._mttr_samples: List[float] = []
        #: closed fault windows as ``(opened, repaired)`` monotonic stamps
        #: — the joinable form of ``_mttr_samples`` (the SLO engine lines
        #: these up against the latency timeline for chaos attribution)
        self.fault_events: List[Tuple[float, float]] = []
        #: coordinator flight recorder: the merge target for every
        #: worker/agent frame that ships home (``repro_torch.obs``)
        self.recorder = FlightRecorder("coordinator")
        #: Prometheus-style registry; scraped by ``repro_torch.service`` and
        #: snapshotted into ``FleetReport.obs``
        self.metrics = MetricsRegistry()
        self._m_dispatch = self.metrics.counter(
            "repro_fleet_dispatch_total", "bundle dispatches")
        self._m_requeue = self.metrics.counter(
            "repro_fleet_requeue_total", "bundles returned for retry")
        self._m_deaths = self.metrics.counter(
            "repro_fleet_worker_deaths_total", "reaped peers")
        self._m_heartbeats = self.metrics.counter(
            "repro_fleet_heartbeats_total", "liveness pings observed")
        self._m_done = self.metrics.counter(
            "repro_fleet_done_total", "bundles completed")
        self._m_skip = self.metrics.counter(
            "repro_fleet_skip_total", "bundles skipped (degraded mode)")
        self._m_scale = self.metrics.counter(
            "repro_fleet_scale_events_total", "elasticity events")
        self._m_workers = self.metrics.gauge(
            "repro_fleet_workers", "current worker slots")
        self._m_replay = self.metrics.histogram(
            "repro_fleet_replay_seconds", "dispatch-to-result latency")
        self._m_queue = self.metrics.histogram(
            "repro_fleet_queue_seconds", "pending-queue residency")

    def _absorb_frame(self, peer: Peer, frame: Optional[ObsFrame]) -> None:
        """Merge a piggybacked worker/agent buffer onto the coordinator
        timeline: fold the frame's clock echo into the peer's offset
        estimate, then rebase every event through it."""
        if frame is None:
            return
        t_recv = obs_clock.now()
        if frame.echo_t is not None:
            peer.sync.observe(frame.echo_t, frame.sent_at, t_recv)
        self.recorder.absorb(
            frame, peer.sync.to_local if peer.sync.synced else None)

    def obs_snapshot(self, last_n: Optional[int] = None) -> Dict:
        """The ``FleetReport.obs`` payload: merged timeline (bounded),
        drop accounting, metrics snapshot."""
        snap = self.recorder.snapshot(last_n)
        snap["metrics"] = self.metrics.snapshot()
        return snap

    # -- pool plumbing ------------------------------------------------------

    def _reap(self, peer: Peer, pending: Deque[int],
              epoch: Optional[int] = None, *, hung: bool = False) -> None:
        """A peer died: requeue its in-flight bundles (only those belonging
        to the current run — stragglers from a raised run are dropped),
        then refill the pool.  ``hung`` peers get no teardown grace."""
        self.worker_deaths += 1
        self._m_deaths.inc()
        self.recorder.record("fault_opened", peer=peer.scope,
                             hung=hung,
                             in_flight=sorted(i for _, i in peer.tasks))
        for e, idx in peer.tasks:
            if epoch is not None and e == epoch:
                pending.appendleft(idx)
        peer.tasks.clear()
        if hung:
            peer.destroy()
        else:
            peer.close()
        self._peers.remove(peer)
        self._refill(pending)

    def _refill(self, pending: Deque[int]) -> None:
        """Hook: replace a reaped peer if the transport can."""

    def _tick(self, pending: Deque[int]) -> None:
        """Hook: service deferred pool work each scheduler pass (the
        backoff respawn queue, for transports that have one)."""

    def _pending_refill(self) -> bool:
        """Hook: is a deferred replacement (backoff respawn) still due?
        While True, an empty pool is *recovering*, not dead."""
        return False

    def _note_ready(self) -> None:
        """A peer reported ready: close the oldest open fault's MTTR
        window, if a refill was outstanding."""
        if self._fault_opened:
            opened = self._fault_opened.popleft()
            now = obs_clock.now()
            self._mttr_samples.append(now - opened)
            self.fault_events.append((opened, now))
            self.recorder.record("fault_repaired", mttr_s=now - opened)

    def _scale_up(self) -> bool:
        """Hook: add one peer of capacity (autoscale).  Returns True if the
        pool grew.  The base pool cannot grow."""
        return False

    def _retire(self, peer: Peer) -> None:
        """Politely release an idle peer (autoscale down).  Not a death:
        no requeue, no refill, no ``worker_deaths``."""
        peer.stop()
        if hasattr(peer, "drain_obs"):
            self._absorb_frame(peer, peer.drain_obs(0.2))
        peer.close()
        self._peers.remove(peer)
        self.scale_downs += 1
        self._m_scale.inc(direction="down")
        self.recorder.record("scale_down", peer=peer.scope)

    def _assemble(self, timeout: float) -> None:
        """Hook: block until the initial pool is usable (RemoteFleet gates
        the first stream on its join quorum here)."""

    def _extra_waitables(self) -> List:
        return []

    def _handle_extra(self, obj) -> None:
        raise NotImplementedError(f"unexpected waitable {obj!r}")

    def _close_extras(self) -> None:
        pass

    def _wait(self, timeout: float, *, ready_only: bool = False) -> List:
        conns = [p.waitable for p in self._peers
                 if not (ready_only and p.ready)]
        conns += self._extra_waitables()
        return mp_conn.wait(conns, timeout=timeout) if conns else []

    def _peer_for(self, obj) -> Optional[Peer]:
        return next((p for p in self._peers if p.waitable is obj), None)

    def _warming(self) -> bool:
        return any(p.alive and not p.ready for p in self._peers)

    # -- lifecycle ----------------------------------------------------------

    def warmup(self, timeout: float = 120.0) -> List[Dict]:
        """Block until every live peer reported ready (and any subclass
        minimum-pool condition holds); returns their ready infos.  Not
        required before ``run`` (dispatches queue in the transport), but
        useful to separate spawn/connect/trace cost from replay cost —
        ``benchmarks/bench_fleet.py`` does exactly that."""
        deadline = time.monotonic() + timeout
        infos: List[Dict] = []
        while self._warming() or (not self._peers and self._pending_refill()):
            if time.monotonic() > deadline:
                raise TimeoutError("fleet workers did not become ready "
                                   f"within {timeout}s")
            self._tick(deque())
            evs = self._wait(0.5, ready_only=True)
            if not evs and not self._peers:
                time.sleep(0.05)      # backoff respawn still pending
            for obj in evs:
                peer = self._peer_for(obj)
                if peer is None:
                    self._handle_extra(obj)
                    continue
                try:
                    msg = peer.recv()
                except PeerGone:
                    self._reap(peer, deque())
                    continue
                peer.last_seen = time.monotonic()
                if msg[0] == "ready":
                    peer.ready = True
                    self._note_ready()
                    infos.append(msg[1])
                elif msg[0] == "err":
                    # ("err", epoch, idx, traceback[, frame]): the
                    # traceback, not the trailing frame the JAX package
                    # prints here
                    raise RuntimeError(
                        f"fleet worker failed to initialize:\n{msg[3]}")
                # "ping": watermark refreshed above, nothing else to do
        if not self._peers:
            raise RuntimeError("no fleet worker survived initialization")
        return infos

    # -- execution ----------------------------------------------------------

    def stream(self, bundles: Iterable[ScheduleBundle], *,
               timeout: float = 600.0, window: Optional[int] = None,
               max_attempts: Optional[int] = None,
               liveness_timeout: Optional[float] = None,
               speculate: Optional[float] = None,
               on_failure: str = "raise",
               record_timing: Optional[
                   Callable[[int, BundleTiming], None]] = None,
               idle_retire_s: Optional[float] = None
               ) -> Iterator[Tuple[int, EmulationReport]]:
        """Replay a (possibly lazy) bundle source; yields ``(idx, report)``
        pairs in completion order.

        This is the iterator-of-bundles contract: the source is pulled
        only while fewer than ``window`` bundles are outstanding (pulled
        but unfinished), so a source that compiles on ``next()`` is
        backpressured by worker throughput and coordinator memory stays
        bounded by the window, not the stream length.  ``window=None``
        tracks the pool at ``2 × worker slots`` (recomputed as the pool
        scales), keeping every slot fed while leaving queue depth visible
        to the autoscaler.

        *Arrival-time admission*: the source may yield ``None`` to say
        "nothing available right now" — the scheduler stops admitting for
        this pass but keeps dispatching/collecting, and asks again on the
        next pass.  That turns a pre-built iterator contract into an
        open-loop one: a standing serve loop backed by a live queue
        (``repro_torch.service.standing``) yields ``None`` while the queue is
        empty and raises ``StopIteration`` only on drain/close.

        *Dependency edges*: a bundle whose ``parents`` tuple is
        non-empty is admitted (it occupies a window slot) but joins the
        pending queue only once every parent's result has been yielded —
        the dispatchable *frontier*.  Parents must reference earlier
        stream indices; forward/self references (the only way to express
        a cycle, since indices are assigned in arrival order) raise
        ``ValueError`` at admission instead of deadlocking.  Queue time
        starts at *release*, not admission, so ``BundleTiming.queue_s``
        never charges a child for its parents' replay.  A requeued
        (killed/hung) parent keeps its children blocked until the retry
        lands; a *skipped* parent (``on_failure="skip"``) cascades — all
        transitively-blocked descendants are skipped as ``(idx, None)``
        with reason ``"ancestor"`` and counted in
        ``last_recovery["skipped_ancestor"]`` (and live in
        ``last_ancestor_skips``), distinct from direct poison.
        Edge-free bundles take the identical pre-DAG path bit for bit.

        Hardening knobs:

        * ``max_attempts`` — per-bundle dispatch budget before the bundle
          is declared poison (default ``_MAX_ATTEMPTS`` = 3).
        * ``liveness_timeout`` — a *ready* peer holding in-flight work
          that has been silent this long is reaped as hung (requeue, no
          teardown grace).  Pair with a heartbeating spec: without
          heartbeats a worker legitimately busy on a long bundle is
          indistinguishable from a wedged one.
        * ``speculate=p`` — once the pending queue is empty, a bundle in
          flight past ``p ×`` the median completion time (of the last 64
          completions, needs ≥ 3 samples) is re-dispatched to a free
          slot; first result wins, the loser's late reply is discarded by
          the epoch/held machinery.  Costs one attempt from the budget.
        * ``on_failure="skip"`` — a worker-reported bundle failure or an
          exhausted attempt budget *skips* that bundle instead of
          raising, and the stream keeps draining.  A skipped bundle is
          announced as ``(idx, None)`` so a consumer folding in index
          order can advance past the hole promptly (and is recorded in
          ``last_recovery["skipped"]``).
        * ``record_timing`` — callback invoked once per bundle (just
          before its result is yielded, or when it is skipped) with
          ``(idx, BundleTiming)``: separate enqueue/dispatch/done stamps
          plus honest queue-vs-replay split (a post-fault requeue charges
          queue time, never replay time).
        * ``idle_retire_s`` — autoscale only: when the pending queue
          stays below the pool floor (``min_workers``) for this long
          mid-stream, one idle worker is retired per elapsed window (the
          pool never drops below the floor).  Defaults to
          ``liveness_timeout`` when armed, so "a full liveness window of
          low queue depth" is the retire signal; with neither set,
          mid-stream scale-down is off and only the drain-time retire
          runs.  Retires are counted in ``last_scaling`` under both
          ``scale_downs`` and ``midstream_downs``.

        Raises RuntimeError on a peer-reported replay failure or poison
        bundle (under ``on_failure="raise"``), ``CrashLoopError`` when
        the transport's breaker trips, RuntimeError when the whole pool
        is dead (with no respawn due) and work is still pending;
        TimeoutError past the deadline.  Completed bundles are dropped as
        their reports are yielded — a raised stream's stragglers are
        recognized by their stale epoch in later runs, exactly like
        ``run``'s.
        """
        if self._closed:
            raise RuntimeError(f"{type(self).__name__} is closed")
        if on_failure not in ("raise", "skip"):
            raise ValueError(f"on_failure must be 'raise' or 'skip', "
                             f"got {on_failure!r}")
        max_att = _MAX_ATTEMPTS if max_attempts is None else int(max_attempts)
        if max_att < 1:
            raise ValueError(f"max_attempts must be >= 1, got {max_attempts}")
        if speculate is not None and speculate < 1.0:
            raise ValueError("speculate is a multiple of the median "
                             f"completion time and must be >= 1.0, "
                             f"got {speculate}")
        self._assemble(timeout)
        # A raised run (worker error, poison bundle, timeout) leaves
        # stragglers replaying on live peers.  Each run gets a fresh
        # epoch: stragglers' late results are recognized by their stale
        # epoch, discarded, and merely free their slot — they are never
        # yielded into this run and never block dispatch forever.
        self._epoch += 1
        epoch = self._epoch
        source = iter(bundles)
        exhausted = False
        next_idx = 0
        held: Dict[int, ScheduleBundle] = {}   # pulled, result not yielded
        pending: Deque[int] = deque()
        attempts: Dict[int, int] = {}
        deadline = time.monotonic() + timeout
        base_ups, base_downs = self.scale_ups, self.scale_downs
        base_deaths, base_hung = self.worker_deaths, self.hung_reaped
        base_mttr = len(self._mttr_samples)
        base_fev = len(self.fault_events)
        peak_workers = peak_queue = peak_window = 0
        midstream_downs = 0
        low_q_since: Optional[float] = None  # dwell timer for idle retire
        retire_s = idle_retire_s if idle_retire_s is not None \
            else liveness_timeout
        # -- recovery accounting (this stream only) --------------------------
        disp_at: Dict[int, float] = {}       # idx -> latest dispatch time
        requeue_ts: Dict[int, float] = {}    # idx -> when it re-entered pending
        # -- per-bundle lifecycle stamps (BundleTiming) ----------------------
        enq_at: Dict[int, float] = {}        # idx -> admission time
        q_since: Dict[int, float] = {}       # idx -> entered pending (latest)
        q_wait: Dict[int, float] = {}        # idx -> accumulated queue time
        done_times: List[float] = []         # dispatch->ok latencies
        skipped: List[int] = []
        # -- dependency frontier (bundles with parents edges) ----------------
        blocked: Dict[int, Set[int]] = {}    # idx -> unmet parent idxs
        dependants: Dict[int, List[int]] = {}  # parent -> blocked children
        completed: Set[int] = set()          # idxs whose result was yielded
        skipped_set: Set[int] = set()        # fast ancestor-doom lookup
        anc_skipped: List[int] = []          # cascade holes, not poison
        self.last_ancestor_skips = set()
        requeued = 0
        requeue_wait = 0.0
        requeue_waits = 0
        lost_replay = 0.0
        spec_extra: Set[int] = set()         # idxs with a live second copy
        spec_peer: Dict[int, Peer] = {}      # idx -> its speculative peer
        spec_dispatches = spec_wins = 0
        pings = 0

        def account_requeue(peer: Peer, now: float) -> None:
            """Charge a dying/hung peer's current-epoch work before _reap
            requeues it: count the requeue and the replay time lost."""
            nonlocal requeued, lost_replay
            for e, i in peer.tasks:
                if e == epoch and i in held:
                    requeued += 1
                    self._m_requeue.inc()
                    self.recorder.record("requeue", idx=i,
                                         reason="peer-died",
                                         peer=peer.scope)
                    t = disp_at.pop(i, None)
                    if t is not None:
                        lost_replay += now - t
                    requeue_ts[i] = now
                    q_since[i] = now        # back in the queue: the clock
                    # charges queue time again, never replay time

        def skip(idx: int, ancestor: Optional[int] = None) -> None:
            now = obs_clock.now()
            skipped.append(idx)
            skipped_set.add(idx)
            self._m_skip.inc()
            if ancestor is None:
                self.recorder.record("skip", idx=idx)
            else:
                # a cascade hole: this bundle never failed — a bundle it
                # (transitively) depends on did
                anc_skipped.append(idx)
                self.last_ancestor_skips.add(idx)
                self.recorder.record("skip", idx=idx, reason="ancestor",
                                     parent=ancestor)
            blocked.pop(idx, None)
            held.pop(idx, None)
            att = attempts.pop(idx, None)
            t = disp_at.pop(idx, None)
            spec_extra.discard(idx)
            spec_peer.pop(idx, None)
            requeue_ts.pop(idx, None)
            qw = q_wait.pop(idx, 0.0)
            qs = q_since.pop(idx, None)
            if qs is not None:              # skipped while still queued
                qw += now - qs
            enq = enq_at.pop(idx, now)
            if record_timing is not None:
                record_timing(idx, BundleTiming(
                    enqueued=enq, dispatched=t, done=now, queue_s=qw,
                    replay_s=0.0, attempts=att or 0, ok=False))

        def doomed(idx: int) -> List[int]:
            """Descendants transitively blocked on a just-skipped ``idx``
            — they can never dispatch, so the caller skips them too.  A
            multi-parent child reached through a second doomed parent is
            guarded by the ``blocked`` membership test (it was already
            unblocked-by-doom the first time)."""
            out: List[int] = []
            frontier = [idx]
            while frontier:
                p = frontier.pop(0)
                for c in sorted(dependants.pop(p, ())):
                    if c in blocked:
                        del blocked[c]
                        out.append(c)
                        frontier.append(c)
            return sorted(out)

        try:
            while True:
                # -- admission: compile-ahead at most `window` bundles ----
                cap = sum(p.capacity for p in self._peers) or 1
                win = window if window is not None else max(2 * cap, 2)
                saw_none = False
                while not exhausted and len(held) < win:
                    try:
                        b = next(source)
                    except StopIteration:
                        exhausted = True
                        break
                    if b is None:
                        # open-loop source: nothing has arrived yet — stop
                        # admitting this pass, keep the scheduler turning
                        saw_none = True
                        break
                    idx = next_idx
                    next_idx += 1
                    parents = bundle_parents(b)
                    if parents:
                        parents = validate_parents(
                            idx, parents, getattr(b, "command", ""))
                    now = obs_clock.now()
                    if any(p in skipped_set for p in parents):
                        # doomed on arrival: an ancestor is already a
                        # hole — announce this one immediately
                        anc = next(p for p in sorted(parents)
                                   if p in skipped_set)
                        enq_at[idx] = now
                        self.recorder.record("enqueue", idx=idx,
                                             parents=list(parents))
                        skip(idx, ancestor=anc)
                        yield idx, None
                        continue
                    held[idx] = b
                    attempts[idx] = 0
                    enq_at[idx] = now
                    unmet = {p for p in parents if p not in completed}
                    if unmet:
                        # admitted but not dispatchable: enters pending
                        # only when the last parent's result lands —
                        # q_since stamps at *release*, so queue_s never
                        # charges a child for its parents' replay
                        blocked[idx] = unmet
                        for p in unmet:
                            dependants.setdefault(p, []).append(idx)
                        self.recorder.record("enqueue", idx=idx,
                                             parents=list(parents))
                        self.recorder.record("dep_wait", idx=idx,
                                             unmet=sorted(unmet))
                        continue
                    pending.append(idx)
                    q_since[idx] = now
                    if parents:
                        self.recorder.record("enqueue", idx=idx,
                                             parents=list(parents))
                    else:
                        self.recorder.record("enqueue", idx=idx)
                if exhausted and not held:
                    break
                peak_window = max(peak_window, len(held))
                peak_queue = max(peak_queue, len(pending))
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"fleet run exceeded {timeout}s with {len(held)} "
                        "bundle(s) unfinished")
                self._tick(pending)    # service due backoff respawns
                # -- dispatch to free slots (death noticed on send is
                # handled exactly like death noticed on receive)
                for peer in list(self._peers):
                    while pending and peer.free_slots > 0:
                        if not peer.alive:
                            account_requeue(peer, time.monotonic())
                            self._reap(peer, pending, epoch)
                            break
                        idx = pending.popleft()
                        if idx not in held:
                            # completed by a speculative twin or skipped
                            # while it waited in the queue — nothing to do
                            continue
                        if attempts[idx] >= max_att:
                            if on_failure == "skip":
                                skip(idx)
                                yield idx, None
                                for c in doomed(idx):
                                    skip(c, ancestor=idx)
                                    yield c, None
                                continue
                            raise RuntimeError(
                                f"bundle {idx} ({held[idx].command!r}) "
                                f"failed {attempts[idx]} dispatch attempts "
                                "— poison bundle, aborting the fleet run")
                        attempts[idx] += 1
                        try:
                            peer.dispatch(epoch, idx, held[idx])
                        except PeerGone:
                            pending.appendleft(idx)
                            attempts[idx] -= 1
                            account_requeue(peer, time.monotonic())
                            self._reap(peer, pending, epoch)
                            break
                        now = obs_clock.now()
                        disp_at[idx] = now
                        self._m_dispatch.inc()
                        self.recorder.record("dispatch", idx=idx,
                                             peer=peer.scope,
                                             attempt=attempts[idx])
                        # a dispatch is an interaction: restart the liveness
                        # window, or a peer idle longer than the timeout
                        # would be reaped the moment it got new work
                        peer.last_seen = now
                        t = requeue_ts.pop(idx, None)
                        if t is not None:
                            requeue_wait += now - t
                            requeue_waits += 1
                        qs = q_since.pop(idx, None)
                        if qs is not None:
                            q_wait[idx] = q_wait.get(idx, 0.0) + (now - qs)
                # -- elasticity: queue depth drives the pool size ---------
                if self._autoscale:
                    if pending and not any(p.alive and p.free_slots > 0
                                           for p in self._peers):
                        if self._scale_up():
                            self._m_scale.inc(direction="up")
                            self.recorder.record(
                                "scale_up", workers=len(self._peers))
                        low_q_since = None
                    elif exhausted and not pending:
                        # long tail: peers that already drained go idle
                        # while stragglers finish — release them early
                        idle = [p for p in self._peers if not p.tasks]
                        for p in idle[:len(self._peers) - self._scale_min]:
                            self._retire(p)
                    elif retire_s is not None \
                            and len(pending) < self._scale_min \
                            and len(self._peers) > self._scale_min:
                        # mid-stream scale-down: queue depth has stayed
                        # below the pool floor for a full window — a
                        # standing fleet between load peaks sheds one idle
                        # worker per elapsed window instead of holding its
                        # storm-sized pool until drain
                        now_e = time.monotonic()
                        if low_q_since is None:
                            low_q_since = now_e
                        elif now_e - low_q_since >= retire_s:
                            victim = next(
                                (p for p in self._peers
                                 if p.ready and not p.tasks), None)
                            if victim is not None:
                                self._retire(victim)
                                midstream_downs += 1
                            low_q_since = now_e
                    else:
                        low_q_since = None
                cap_now = sum(p.capacity for p in self._peers)
                peak_workers = max(peak_workers, cap_now)
                self._m_workers.set(cap_now)
                # -- liveness: reap hung-but-connected peers --------------
                if liveness_timeout is not None:
                    now = time.monotonic()
                    for peer in list(self._peers):
                        # only *ready* peers: a still-warming worker is
                        # paying its torch-import bill, not hanging
                        if peer.ready and peer.tasks \
                                and now - peer.last_seen > liveness_timeout:
                            self.hung_reaped += 1
                            account_requeue(peer, now)
                            self._reap(peer, pending, epoch, hung=True)
                # -- speculation: soft per-bundle timeout -----------------
                if speculate is not None and not pending \
                        and len(done_times) >= 3:
                    median = statistics.median(done_times[-64:])
                    threshold = speculate * median
                    now = time.monotonic()
                    for peer in list(self._peers):
                        for e, idx in list(peer.tasks):
                            if (e != epoch or idx not in held
                                    or idx in spec_extra
                                    or attempts[idx] >= max_att
                                    or now - disp_at.get(idx, now)
                                    <= threshold):
                                continue
                            twin = next(
                                (p for p in self._peers
                                 if p is not peer and p.alive and p.ready
                                 and p.free_slots > 0), None)
                            if twin is None:
                                continue
                            attempts[idx] += 1
                            try:
                                twin.dispatch(epoch, idx, held[idx])
                            except PeerGone:
                                attempts[idx] -= 1
                                account_requeue(twin, time.monotonic())
                                self._reap(twin, pending, epoch)
                                continue
                            spec_extra.add(idx)
                            spec_peer[idx] = twin
                            spec_dispatches += 1
                            disp_at[idx] = obs_clock.now()
                            twin.last_seen = disp_at[idx]
                            self._m_dispatch.inc()
                            self.recorder.record(
                                "dispatch", idx=idx, peer=twin.scope,
                                attempt=attempts[idx], speculative=True)
                if not self._peers and not self._pending_refill():
                    raise RuntimeError(
                        f"all fleet workers died ({self.worker_deaths} "
                        f"death(s)) with {len(held)} bundle(s) pending")
                # -- collect ----------------------------------------------
                # an open-loop pass (source had nothing *yet*) polls fast:
                # the next arrival should not sit in its feed queue for a
                # full peer-wait interval before admission
                evs = self._wait(0.02 if saw_none else 0.5)
                if not evs and not self._peers:
                    time.sleep(0.05)   # backoff respawn still pending
                for obj in evs:
                    peer = self._peer_for(obj)
                    if peer is None:
                        self._handle_extra(obj)
                        continue
                    try:
                        msg = peer.recv()
                    except PeerGone:
                        account_requeue(peer, time.monotonic())
                        self._reap(peer, pending, epoch)
                        continue
                    now = obs_clock.now()
                    peer.last_seen = now
                    kind = msg[0]
                    if kind == "ping":
                        pings += 1
                        self._m_heartbeats.inc()
                        self.recorder.record("heartbeat", peer=peer.scope)
                    elif kind == "ready":
                        peer.ready = True
                        self._note_ready()
                    elif kind == "obs":
                        # a final buffer shipped on stop/drain
                        self._absorb_frame(peer, msg[1])
                    elif kind == "ok":
                        e, idx, rep = msg[1], msg[2], msg[3]
                        self._absorb_frame(peer,
                                           msg[4] if len(msg) > 4 else None)
                        peer.tasks.discard((e, idx))
                        if e == epoch and idx in held:
                            t = disp_at.pop(idx, None)
                            if t is not None:
                                done_times.append(max(0.0, now - t))
                                self._m_replay.observe(max(0.0, now - t))
                            twin = spec_peer.pop(idx, None)
                            if twin is not None and twin is peer:
                                spec_wins += 1
                            spec_extra.discard(idx)
                            del held[idx]
                            att = attempts.pop(idx, None)
                            q_since.pop(idx, None)
                            qw = q_wait.pop(idx, 0.0)
                            self._m_queue.observe(qw)
                            self._m_done.inc()
                            self.recorder.record("done", idx=idx,
                                                 peer=peer.scope)
                            # frontier release: children whose last
                            # unmet parent this was become dispatchable
                            completed.add(idx)
                            for c in sorted(dependants.pop(idx, ())):
                                un = blocked.get(c)
                                if un is None:
                                    continue
                                un.discard(idx)
                                if not un:
                                    del blocked[c]
                                    q_since[c] = now
                                    pending.append(c)
                                    self.recorder.record("dep_release",
                                                         idx=c, parent=idx)
                            enq = enq_at.pop(idx, now)
                            if record_timing is not None:
                                record_timing(idx, BundleTiming(
                                    enqueued=enq, dispatched=t, done=now,
                                    queue_s=qw,
                                    replay_s=(max(0.0, now - t)
                                              if t is not None else 0.0),
                                    attempts=att or 1, ok=True))
                            yield idx, rep
                    elif kind == "retry":
                        _, e, idx, _reason = msg
                        peer.tasks.discard((e, idx))
                        if e == epoch and idx in held \
                                and idx not in pending:
                            requeued += 1
                            self._m_requeue.inc()
                            self.recorder.record("requeue", idx=idx,
                                                 reason=str(_reason),
                                                 peer=peer.scope)
                            t = disp_at.pop(idx, None)
                            if t is not None:
                                lost_replay += now - t
                            requeue_ts[idx] = now
                            q_since[idx] = now
                            pending.append(idx)
                    elif kind == "err":
                        e, idx, tb = msg[1], msg[2], msg[3]
                        self._absorb_frame(peer,
                                           msg[4] if len(msg) > 4 else None)
                        if idx is None:
                            raise RuntimeError(
                                "fleet worker failed on initialization:"
                                f"\n{tb}")
                        peer.tasks.discard((e, idx))  # terminal either way
                        if e == epoch and idx in held:
                            if on_failure == "skip":
                                skip(idx)
                                yield idx, None
                                for c in doomed(idx):
                                    skip(c, ancestor=idx)
                                    yield c, None
                                continue
                            raise RuntimeError(
                                f"fleet worker ({peer.describe()}) failed "
                                f"on bundle {idx} ({held[idx].command!r}):"
                                f"\n{tb}")
            # -- natural drain: an elastic pool parks back at its floor ---
            if self._autoscale:
                idle = [p for p in self._peers if not p.tasks]
                for p in idle[:len(self._peers) - self._scale_min]:
                    self._retire(p)
        finally:
            self.last_scaling = {
                "scale_ups": self.scale_ups - base_ups,
                "scale_downs": self.scale_downs - base_downs,
                "peak_workers": peak_workers,
                "peak_queue_depth": peak_queue,
                "peak_window": peak_window,
                "midstream_downs": midstream_downs,
            }
            mttr = self._mttr_samples[base_mttr:]
            self.last_recovery = {
                "worker_deaths": self.worker_deaths - base_deaths,
                "hung_reaped": self.hung_reaped - base_hung,
                "requeued": requeued,
                "requeue_latency_s": (requeue_wait / requeue_waits
                                      if requeue_waits else 0.0),
                "lost_replay_s": lost_replay,
                "mttr_s": (sum(mttr) / len(mttr)) if mttr else None,
                "skipped": sorted(skipped),
                "skipped_ancestor": sorted(anc_skipped),
                "speculative_dispatches": spec_dispatches,
                "speculative_wins": spec_wins,
                "heartbeats": pings,
                # (opened, repaired) monotonic stamps of every fault whose
                # MTTR window closed during this stream — joinable against
                # a latency timeline (the service layer's slo does that)
                "fault_events": [
                    (o, r) for o, r in self.fault_events[base_fev:]],
            }

    def run(self, bundles: Iterable[ScheduleBundle], *,
            timeout: float = 600.0, window: Optional[int] = None,
            max_attempts: Optional[int] = None,
            liveness_timeout: Optional[float] = None,
            speculate: Optional[float] = None,
            on_failure: str = "raise") -> List[EmulationReport]:
        """Replay every bundle; returns reports in bundle order.

        The materializing wrapper over ``stream`` — same failure
        semantics, but all reports are held until the source is drained.
        Prefer consuming ``stream`` directly for unbounded sources.
        Under ``on_failure="skip"`` skipped bundles leave no entry, so
        the list may be shorter than the source (``last_recovery`` has
        the skipped indices).
        """
        results: Dict[int, EmulationReport] = {}
        for idx, rep in self.stream(bundles, timeout=timeout, window=window,
                                    max_attempts=max_attempts,
                                    liveness_timeout=liveness_timeout,
                                    speculate=speculate,
                                    on_failure=on_failure):
            if rep is not None:
                results[idx] = rep
        return [results[i] for i in sorted(results)]

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for peer in self._peers:
            peer.stop()
        for peer in self._peers:
            # collect the final buffer a stopping peer ships (events
            # since its last result — the stop-frame piggyback)
            if hasattr(peer, "drain_obs"):
                self._absorb_frame(peer, peer.drain_obs(0.2))
        for peer in self._peers:
            peer.close()
        self._peers.clear()
        self._close_extras()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ---------------------------------------------------------------------------
# local instantiation: worker processes behind multiprocessing Pipes
# ---------------------------------------------------------------------------

class _PipePeer(Peer):
    """One spawn-based worker process behind a ``Pipe``: capacity 1.

    The on-pipe worker protocol (``repro_torch.fleet.worker``) predates
    epochs — a capacity-1 worker replays serially, so the epoch of any
    reply is simply the epoch its single in-flight task was dispatched
    under; this adapter re-attaches it.
    """

    __slots__ = ("proc", "conn", "tasks", "ready")

    def __init__(self, proc, conn):
        super().__init__()
        self.proc = proc
        self.conn = conn

    @property
    def alive(self) -> bool:
        return self.proc.is_alive()

    @property
    def waitable(self):
        return self.conn

    def dispatch(self, epoch, idx, bundle):
        try:
            # the trailing stamp is the clock echo: the worker copies it
            # into the ObsFrame it ships home, closing the offset loop
            self.conn.send(("run", idx, bundle, obs_clock.now()))
        except (BrokenPipeError, OSError) as e:
            raise PeerGone(str(e)) from e
        self.tasks.add((epoch, idx))

    def recv(self):
        try:
            msg = self.conn.recv()
        except (EOFError, ConnectionResetError, OSError) as e:
            raise PeerGone(str(e)) from e
        kind = msg[0]
        if kind == "ping":
            return ("ping",)
        if kind == "ready":
            return ("ready", msg[1])
        if kind == "obs":
            return ("obs", msg[1])
        if kind == "ok":
            idx, rep = msg[1], msg[2]
            frame = msg[3] if len(msg) > 3 else None
            return ("ok", self.epoch_for(idx), idx, rep, frame)
        if kind == "err":
            idx, tb = msg[1], msg[2]
            frame = msg[3] if len(msg) > 3 else None
            return ("err", self.epoch_for(idx), idx, tb, frame)
        return ("err", None, None, f"unknown worker message {kind!r}")

    def stop(self):
        if self.alive:
            try:
                self.conn.send(("stop",))
            except (BrokenPipeError, OSError):
                pass

    def drain_obs(self, timeout: float = 0.5):
        """Best-effort read of the final ``("obs", frame)`` a stopped
        worker ships on its way out; returns the frame or None."""
        deadline = time.monotonic() + timeout
        try:
            while time.monotonic() < deadline:
                if not self.conn.poll(max(0.0, deadline - time.monotonic())):
                    return None
                msg = self.conn.recv()
                if msg and msg[0] == "obs":
                    return msg[1]
        except (EOFError, ConnectionResetError, OSError):
            return None
        return None

    def close(self):
        try:
            self.conn.close()
        except OSError:
            pass
        # instant for a reaped (dead) process; bounded grace for a polite
        # stop — a worker that outlives it is wedged and gets the axe
        self.proc.join(timeout=2.0)
        if self.proc.is_alive():
            self.proc.terminate()
            self.proc.join(timeout=2.0)

    def destroy(self):
        # hung worker: no grace it will never honor — terminate first
        try:
            self.conn.close()
        except OSError:
            pass
        if self.proc.is_alive():
            self.proc.terminate()
        self.proc.join(timeout=2.0)

    def describe(self) -> str:
        return f"worker pid {self.proc.pid}"


class ProcessFleet(FleetBase):
    """A pool of emulator worker processes that replay ``ScheduleBundle``s.

    The pool is warm state: spawn it once, ``run()``/``stream()`` it many
    times (each run reuses the workers' traced programs and plan caches),
    ``close()`` it when done — or use it as a context manager.
    ``worker_deaths`` and ``respawns`` count recovery events across the
    pool's lifetime.

    With ``autoscale=True`` the pool is elastic: it starts at
    ``min_workers`` (default 1), the scheduler spawns up to ``n_workers``
    while queued bundles outnumber free slots, and idle workers are
    retired back to the floor when a stream drains — so a bursty profile
    source pays for exactly the workers its queue depth asked for.
    """

    def __init__(self, n_workers: int, spec: WorkerSpec, *,
                 respawn: bool = True, max_respawns: Optional[int] = None,
                 min_workers: Optional[int] = None, autoscale: bool = False,
                 respawn_backoff: Tuple[float, float] = (0.1, 5.0),
                 crash_loop: Tuple[int, float] = (5, 10.0)):
        if n_workers < 1:
            raise ValueError("ProcessFleet needs n_workers >= 1")
        if min_workers is not None and not autoscale:
            raise ValueError("min_workers is the autoscale floor; pass "
                             "autoscale=True with it")
        if spec.mesh is not None:
            raise NotImplementedError(COLLECTIVE_TODO)
        super().__init__()
        self.spec = spec
        self.n_workers = n_workers
        self.respawns = 0
        self._respawn = respawn
        self._respawns_left = (n_workers if max_respawns is None
                               else max_respawns)
        self._ctx = mp.get_context("spawn")
        self._autoscale = autoscale
        self._scale_max = n_workers
        self._scale_min = max(1, min_workers or 1) if autoscale else n_workers
        if self._scale_min > n_workers:
            raise ValueError(f"min_workers={min_workers} exceeds "
                             f"n_workers={n_workers}")
        # -- respawn pacing: exponential backoff + crash-loop breaker -------
        self._backoff_base, self._backoff_cap = respawn_backoff
        self._crash_limit, self._crash_window = crash_loop
        self._death_log: Deque[float] = deque()   # deaths inside the window
        self._respawn_due: List[float] = []       # deferred spawn deadlines
        self._death_streak = 0
        self._last_death = float("-inf")
        # jitter comes from the chaos-safe seeded RNG so backoff delays —
        # and therefore fault *timings* — replay identically given the
        # same policy seed
        chaos = getattr(spec, "chaos", None)
        self._backoff_rng = (chaos.rng("coordinator")
                             if chaos is not None else Random(0))
        self._spawned = 0                         # spawn-ordinal -> scope
        for _ in range(self._scale_min if autoscale else n_workers):
            self._spawn()

    def _spawn(self) -> None:
        # the spawn ordinal names the worker's deterministic chaos scope:
        # the k-th worker this pool ever starts is "worker:k", on every
        # run with the same policy
        scope = f"worker:{self._spawned}"
        self._spawned += 1
        parent_conn, child_conn = self._ctx.Pipe()
        proc = self._ctx.Process(target=worker_loop,
                                 args=(child_conn, self.spec, scope),
                                 daemon=True)
        proc.start()
        child_conn.close()
        peer = _PipePeer(proc, parent_conn)
        peer.scope = scope          # flight-recorder track == chaos scope
        self._peers.append(peer)

    def _refill(self, pending: Deque[int]) -> None:
        """A worker died: schedule a replacement with exponential backoff
        (a respawn is *deferred*, serviced by ``_tick`` on scheduler
        passes) and trip the crash-loop breaker if this spec keeps dying.
        """
        if not self._respawn or self._respawns_left <= 0:
            return
        now = time.monotonic()
        self._death_log.append(now)
        while self._death_log and now - self._death_log[0] > \
                self._crash_window:
            self._death_log.popleft()
        if self._crash_limit and len(self._death_log) >= self._crash_limit:
            self.recorder.record("crash_loop",
                                 deaths=len(self._death_log),
                                 window_s=self._crash_window)
            raise CrashLoopError(
                f"fleet worker spec is crash-looping: "
                f"{len(self._death_log)} death(s) within "
                f"{self._crash_window:.1f}s (breaker limit "
                f"{self._crash_limit}) — refusing to burn the remaining "
                f"respawn budget ({self._respawns_left})")
        if now - self._last_death <= self._crash_window:
            self._death_streak += 1
        else:
            self._death_streak = 1
        self._last_death = now
        delay = min(self._backoff_cap,
                    self._backoff_base * (2 ** (self._death_streak - 1)))
        delay *= 0.5 + self._backoff_rng.random()     # jitter: 0.5x-1.5x
        self._respawns_left -= 1
        self._fault_opened.append(now)                # MTTR window opens
        self._respawn_due.append(now + delay)

    def _tick(self, pending: Deque[int]) -> None:
        now = time.monotonic()
        due = [t for t in self._respawn_due if t <= now]
        if due:
            self._respawn_due = [t for t in self._respawn_due if t > now]
            for _ in due:
                self.respawns += 1
                self._spawn()

    def _pending_refill(self) -> bool:
        return bool(self._respawn_due)

    def _scale_up(self) -> bool:
        if len(self._peers) >= self._scale_max:
            return False
        self._spawn()
        self.scale_ups += 1
        return True

    @property
    def pids(self) -> List[int]:
        return [p.proc.pid for p in self._peers if p.alive]

    def close(self) -> None:
        """Tear the pool down in parallel: issue every stop first, then
        join all workers against *one* shared grace deadline — closing a
        large (or dead) pool costs one grace period, not one per worker.
        """
        if self._closed:
            return
        self._closed = True
        self._respawn_due.clear()           # no respawns into a closed pool
        peers = list(self._peers)
        self._peers.clear()
        for p in peers:
            p.stop()                        # all stops in flight first
        for p in peers:
            # final flight-recorder buffers ride the stop frame home
            self._absorb_frame(p, p.drain_obs(0.2))
        for p in peers:
            try:
                p.conn.close()
            except OSError:
                pass
        deadline = time.monotonic() + 5.0   # one shared grace for the pool
        for p in peers:
            p.proc.join(timeout=max(0.0, deadline - time.monotonic()))
        for p in peers:                     # stragglers get the axe...
            if p.proc.is_alive():
                p.proc.terminate()
        deadline = time.monotonic() + 2.0   # ...against one shared deadline
        for p in peers:
            if p.proc.is_alive():
                p.proc.join(timeout=max(0.0, deadline - time.monotonic()))
        self._close_extras()


def run_process_fleet(emulator: Emulator, profiles, *, max_workers: int = 4,
                      mesh_spec=None, flops_scale: float = 1.0,
                      storage_scale: float = 1.0, mem_scale: float = 1.0,
                      verify: bool = True, timeout: float = 600.0,
                      fleet: Optional[ProcessFleet] = None,
                      window: Optional[int] = None, autoscale: bool = False,
                      min_workers: Optional[int] = None,
                      collect: str = "reports",
                      max_attempts: Optional[int] = None,
                      liveness_timeout: Optional[float] = None,
                      speculate: Optional[float] = None,
                      on_failure: str = "raise",
                      chaos: Optional[ChaosPolicy] = None,
                      max_respawns: Optional[int] = None) -> FleetReport:
    """Compile → detach → ship, streamed: one-call process-fleet replay.

    Backs ``Emulator.emulate_many(executor="process")``.  ``profiles`` may
    be any iterable — a list or a lazy source like
    ``ProfileStore.stream(...)``: compilation happens as the scheduler
    pulls, at most ``window`` bundles ahead of dispatch, so coordinator
    memory is bounded by the window even for a production day's worth of
    profiles.  Pass ``fleet`` to reuse a warm ``ProcessFleet`` (the caller
    keeps ownership; ``chaos``/``max_respawns`` are then the caller's
    business, baked into the warm pool's spec); otherwise a pool sized
    ``min(max_workers, len(profiles))`` (or starting at ``min_workers``
    when ``autoscale``) is spawned and torn down around this one run.
    The spawned workers replay on ``emulator.device``; ``mesh_spec``
    raises ``NotImplementedError`` until the collective atom is ported.
    ``collect="totals"`` drops per-profile reports and returns aggregates
    only (the bounded-memory soak mode).

    Hardening: ``liveness_timeout`` arms hung-peer reaping (workers are
    spawned heartbeating at a quarter of it), ``speculate``/
    ``max_attempts``/``on_failure`` pass through to ``stream``, and a
    seeded ``chaos`` policy makes every spawned worker inject its
    scheduled faults.  Stats/scaling/recovery are snapshotted even when
    the stream raises — the partial ``FleetReport`` rides on the raised
    exception as ``.fleet_report`` so failure paths keep their recovery
    accounting.

    ``profiles`` may also be a ``WorkloadDag`` (anything with a
    ``parents_map``): each node compiles into a bundle carrying its
    dependency edges, ``stream``'s frontier gates dispatch on them, the
    fold distinguishes cascade holes from direct poison, and the
    returned report's ``dag`` dict carries critical-path accounting
    (``critical_path_s``, ``makespan_s``, per-node ``slack_s``) built
    from the per-bundle timing stamps.  ``collect="totals"`` is rejected
    for dags — it drops exactly the per-node timing the critical path
    needs.
    """
    if mesh_spec is not None:
        raise NotImplementedError(COLLECTIVE_TODO)
    is_dag = hasattr(profiles, "parents_map")
    if is_dag and collect == "totals":
        raise ValueError(
            "collect='totals' is incompatible with a WorkloadDag: totals "
            "mode drops the per-node BundleTiming stamps critical-path "
            "accounting needs — use collect='reports'")
    n_samples = {"n": 0}                 # true profile samples compiled

    def _bundles():
        if is_dag:
            for node in profiles.nodes:
                b = bundle_profile(emulator, node.profile,
                                   mesh_spec=mesh_spec,
                                   flops_scale=flops_scale,
                                   storage_scale=storage_scale,
                                   mem_scale=mem_scale, verify=verify,
                                   parents=node.parents)
                n_samples["n"] += b.n_profile_samples
                yield b
            return
        for p in profiles:
            b = bundle_profile(emulator, p, mesh_spec=mesh_spec,
                               flops_scale=flops_scale,
                               storage_scale=storage_scale,
                               mem_scale=mem_scale, verify=verify)
            n_samples["n"] += b.n_profile_samples
            yield b

    own = fleet is None
    if own:
        n = len(profiles) if hasattr(profiles, "__len__") else None
        workers = max(1, min(max_workers, n)) if n is not None \
            else max(1, max_workers)
        heartbeat_s = (max(0.1, liveness_timeout / 4.0)
                       if liveness_timeout else 0.0)
        fleet = ProcessFleet(workers,
                             WorkerSpec(emulator=emulator.spec(),
                                        mesh=mesh_spec,
                                        heartbeat_s=heartbeat_s,
                                        chaos=chaos,
                                        device=str(emulator.device)),
                             autoscale=autoscale, min_workers=min_workers,
                             max_respawns=max_respawns)
    t0 = time.perf_counter()
    fold = ReportFold(keep_reports=collect != "totals")
    timings: Dict[int, BundleTiming] = {}

    def _snapshot():
        return ({"workers": fleet.n_workers,
                 "worker_deaths": fleet.worker_deaths,
                 "respawns": fleet.respawns},
                dict(fleet.last_scaling), dict(fleet.last_recovery),
                fleet.n_workers)

    def _report(stats, scaling, recovery, n_workers, last_n=None):
        return FleetReport(
            reports=fold.reports, wall_s=time.perf_counter() - t0,
            serial_s=fold.serial_s, max_workers=n_workers,
            cache_stats=stats, totals=fold.totals,
            n_samples=n_samples["n"], n_replayed=fold.n_done,
            scaling=scaling, recovery=recovery,
            obs=fleet.obs_snapshot(last_n),
            dag=(critical_path(profiles.parents_map, timings)
                 if is_dag else {}))

    gen = fleet.stream(_bundles(), timeout=timeout, window=window,
                       max_attempts=max_attempts,
                       liveness_timeout=liveness_timeout,
                       speculate=speculate, on_failure=on_failure,
                       record_timing=(timings.__setitem__
                                      if is_dag else None))
    try:
        for idx, rep in gen:
            if rep is None:
                # degraded-mode hole: fold past it, classifying cascade
                # holes (ancestor skipped) apart from direct poison
                fold.skip(idx,
                          ancestor=idx in fleet.last_ancestor_skips)
            else:
                fold.add(idx, rep)
        snap = _snapshot()
    except BaseException as e:
        # the stream raised: close the generator so its finally has
        # published this run's scaling/recovery, then snapshot — the
        # partially-folded totals and fault accounting ride out on the
        # exception instead of being lost
        gen.close()
        # postmortem: the last events of the merged timeline ride out on
        # the exception (CrashLoopError, poison, timeout) so failure
        # analysis sees the sequence, not just totals
        e.fleet_report = _report(*_snapshot(), last_n=256)
        raise
    finally:
        if own:
            fleet.close()
    return _report(*snap)

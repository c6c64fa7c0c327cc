"""StandingFleet: a persistent serve loop over ``FleetBase.stream``.

``stream`` was built for iterator-of-bundles batch replay: pull, window,
dispatch, drain, done.  A live service needs the inverse admission
model — a warm pool that *waits* for work and accepts bundles at arrival
time.  ``StandingFleet`` bridges the two without a second scheduler: it
feeds ``stream`` a source backed by a thread-safe inbox that yields
``None`` while nothing has arrived (the executor's open-loop admission
contract), so the entire hardened machinery — chaos, liveness reaping,
backoff respawn, autoscale, speculation, skip-mode — serves live traffic
unchanged.

Lifecycle::

    fleet = StandingFleet(em, FleetConfig.process(max_workers=2, ...))
    fleet.warmup()                  # optional: pay spawn cost up front
    idx = fleet.submit(profile)     # at arrival time, any thread
    ...
    result = fleet.drain()          # finish everything submitted
    idx = fleet.submit(profile)     # pool still warm: next serve session
    fleet.close()                   # tear the pool down

Every request gets a :class:`RequestRecord` carrying the executor's
:class:`~repro_torch.fleet.executor.BundleTiming` (separate enqueue,
dispatch and done stamps, queue-vs-replay split honest under chaos
requeues) plus the
submit/complete wall stamps the serve layer adds.  Totals fold in index
order through ``ReportFold`` so an elastic, fault-injected serve session
reports aggregate totals bit-identical to a clean batch run over the
same profiles.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from repro_torch.core.emulator import (EmulationReport, FleetReport,
                                       ReportFold)
from repro_torch.fleet.bundle import ScheduleBundle, bundle_profile
from repro_torch.fleet.config import FleetConfig
from repro_torch.fleet.executor import BundleTiming
from repro_torch.obs import clock as obs_clock

_CLOSE = object()          # inbox sentinel: end the current serve session


@dataclass
class RequestRecord:
    """One submitted request's lifecycle, as the serve layer saw it.
    ``submitted``/``done`` are ``repro_torch.obs.clock`` stamps;
    ``timing`` is the executor's per-bundle view (None until the bundle
    finishes — and permanently None for requests consumed by a raised
    stream)."""

    idx: int
    command: str
    submitted: float
    meta: Optional[dict] = None
    timing: Optional[BundleTiming] = None
    done: Optional[float] = None
    ok: Optional[bool] = None


@dataclass
class ServeResult:
    """One drained serve session: per-request records (submit order),
    index-order-folded totals, and the fleet's scaling/recovery
    accounting for the session's stream."""

    records: List[RequestRecord]
    totals: object
    serial_s: float
    n_ok: int
    n_skipped: int
    wall_s: float
    scaling: Dict = field(default_factory=dict)
    recovery: Dict = field(default_factory=dict)
    #: observability snapshot (``FleetBase.obs_snapshot``): the merged
    #: flight-recorder timeline, drop accounting, and a metrics snapshot
    obs: Dict = field(default_factory=dict)

    def fleet_report(self) -> FleetReport:
        """This serve session reshaped as the executor's
        :class:`FleetReport` — the one versioned serialization
        (``to_json``, schema-tagged) the service layer ships.  The serve
        layer does not retain per-request ``EmulationReport``s, so
        ``reports`` is empty; totals, scaling, recovery and the obs
        snapshot carry the session."""
        return FleetReport(
            reports=[], wall_s=self.wall_s, serial_s=self.serial_s,
            max_workers=int(self.scaling.get("peak_workers", 0) or 0),
            totals=self.totals, n_replayed=self.n_ok,
            scaling=dict(self.scaling), recovery=dict(self.recovery),
            obs=dict(self.obs))


class StandingFleet:
    """A warm process/remote pool serving requests at arrival time.

    ``config`` must describe a pool that exists between requests —
    ``executor='process'`` or ``'remote'`` (the thread path replays
    in-process and has nothing to keep warm).  ``timeout_s`` bounds one
    serve *session* (start → drain), defaulting to ``config.timeout``;
    a long-lived service should pass the session length it means.

    ``fleet=`` injects a pre-built pool (tests use an in-process loopback
    fleet); the injected pool's lifecycle stays with the caller.
    """

    def __init__(self, emulator, config: FleetConfig, *,
                 fleet=None, timeout_s: Optional[float] = None):
        if fleet is None:
            # build() validates the executor choice and owns the spawn;
            # the workers replay on the emulator's device
            fleet = config.build(config.worker_spec(
                emulator.spec(), device=str(emulator.device)))
            self._owns_fleet = True
        else:
            self._owns_fleet = False
        self._em = emulator
        self._cfg = config
        self._fleet = fleet
        self._timeout = timeout_s if timeout_s is not None \
            else config.timeout
        self._inbox: "queue.Queue" = queue.Queue()
        self._lock = threading.Lock()
        self._records: Dict[int, RequestRecord] = {}
        self._fold = ReportFold(keep_reports=False)
        self._on_complete: List[Callable] = []
        self._pump: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._next_idx = 0
        self._session_t0 = 0.0
        self._closed = False

    # -- introspection ------------------------------------------------------

    @property
    def fleet(self):
        """The underlying pool (scaling/recovery counters live there)."""
        return self._fleet

    @property
    def active(self) -> bool:
        return self._pump is not None and self._pump.is_alive()

    @property
    def pending(self) -> int:
        """Requests submitted but not yet completed this session."""
        with self._lock:
            return sum(1 for r in self._records.values() if r.done is None)

    def on_complete(self, cb: Callable[[RequestRecord,
                                        Optional[EmulationReport]], None]):
        """Register a completion hook (runs on the pump thread, in
        completion order).  The SLO engine attaches here.  Returns an
        unsubscribe callable, so a load run on a shared standing pool can
        detach its hook when it finishes."""
        self._on_complete.append(cb)

        def unsubscribe():
            try:
                self._on_complete.remove(cb)
            except ValueError:
                pass
        return unsubscribe

    # -- lifecycle ----------------------------------------------------------

    def warmup(self, timeout: float = 120.0):
        """Block until the pool's workers report ready — pays the spawn,
        torch-import and CUDA-context bill before the first arrival
        instead of under it."""
        return self._fleet.warmup(timeout)

    def submit(self, profile=None, *, bundle: Optional[ScheduleBundle] = None,
               meta: Optional[dict] = None) -> int:
        """Accept one request *now*; returns its session-local index.

        Pass a ``SynapseProfile`` (compiled here against the config's
        mesh) or a pre-built ``ScheduleBundle``.  Thread-safe; the first
        submit after construction or a drain starts a serve session on
        the warm pool.
        """
        if self._closed:
            raise RuntimeError("StandingFleet is closed")
        if (profile is None) == (bundle is None):
            raise ValueError("pass exactly one of profile= or bundle=")
        if bundle is None:
            bundle = bundle_profile(self._em, profile,
                                    mesh_spec=self._cfg.mesh_spec)
        with self._lock:
            self._raise_pump_error()
            if not self.active:
                self._start_session()
            idx = self._next_idx
            self._next_idx += 1
            self._records[idx] = RequestRecord(
                idx=idx, command=bundle.command,
                submitted=obs_clock.now(), meta=meta)
        self._inbox.put(bundle)
        return idx

    def drain(self, timeout: Optional[float] = None) -> ServeResult:
        """Finish every submitted request, end the session, keep the pool
        warm.  Returns the session's :class:`ServeResult`; re-raises the
        stream's error if the serve loop died."""
        if not self.active:
            self._raise_pump_error()
            raise RuntimeError("no active serve session to drain")
        self._inbox.put(_CLOSE)
        self._pump.join(timeout)
        if self._pump.is_alive():
            raise TimeoutError(f"serve session did not drain in {timeout}s")
        self._pump = None
        self._raise_pump_error()
        return self._session_result()

    def close(self, timeout: Optional[float] = None):
        """Drain (if a session is live) and tear down an owned pool."""
        if self._closed:
            return
        try:
            if self.active:
                self.drain(timeout)
        finally:
            self._closed = True
            if self._owns_fleet:
                self._fleet.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        # on an exception path don't mask it with a drain error
        if exc[0] is not None and self.active:
            self._inbox.put(_CLOSE)
        self.close()
        return False

    # -- serve loop ---------------------------------------------------------

    def _raise_pump_error(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _start_session(self):
        # called under self._lock
        self._records = {}
        self._fold = ReportFold(keep_reports=False)
        self._next_idx = 0
        self._error = None
        self._session_t0 = obs_clock.now()
        self._pump = threading.Thread(target=self._run, name="standing-pump",
                                      args=(self._records, self._fold),
                                      daemon=True)
        self._pump.start()

    def _source(self):
        """The executor-facing request source: inbox → bundles, ``None``
        while idle (open-loop admission), ``StopIteration`` on drain."""
        while True:
            try:
                item = self._inbox.get_nowait()
            except queue.Empty:
                yield None
                continue
            if item is _CLOSE:
                return
            yield item

    def _note_timing(self, records):
        def note(idx: int, timing: BundleTiming):
            rec = records.get(idx)
            if rec is not None:
                rec.timing = timing
        return note

    def _run(self, records, fold):
        try:
            results = self._fleet.stream(
                self._source(), timeout=self._timeout,
                window=self._cfg.window,
                max_attempts=self._cfg.max_attempts,
                liveness_timeout=self._cfg.liveness_timeout,
                speculate=self._cfg.speculate,
                on_failure=self._cfg.on_failure,
                record_timing=self._note_timing(records))
            for idx, rep in results:
                rec = records[idx]
                rec.done = obs_clock.now()
                rec.ok = rep is not None
                if rep is None:
                    fold.skip(idx)
                else:
                    fold.add(idx, rep)
                for cb in self._on_complete:
                    cb(rec, rep)
        except BaseException as e:  # noqa: BLE001 — surfaced on drain/submit
            self._error = e

    def _session_result(self) -> ServeResult:
        with self._lock:
            records = [self._records[i] for i in sorted(self._records)]
        return ServeResult(
            records=records, totals=self._fold.totals,
            serial_s=self._fold.serial_s, n_ok=self._fold.n_done,
            n_skipped=self._fold.n_skipped,
            wall_s=obs_clock.now() - self._session_t0,
            scaling=dict(self._fleet.last_scaling),
            recovery=dict(self._fleet.last_recovery),
            # injected test fleets may predate the recorder: obs is then
            # honestly empty rather than a fabricated snapshot
            obs=(self._fleet.obs_snapshot()
                 if hasattr(self._fleet, "obs_snapshot") else {}))

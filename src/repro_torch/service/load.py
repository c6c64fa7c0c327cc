"""One open-loop load run: arrival process → standing fleet → SLO report.

``run_load`` is the service's core verb, shared by the HTTP surface, the
benchmarks, and the tests: pace an :class:`ArrivalProcess` onto the wall
clock, generate each arrival's scenario profile at fire time, submit it
to a :class:`StandingFleet`, and account every completion into an
:class:`SLOEngine`.  Latency is measured from the request's *scheduled*
arrival, not from submission — a request that waited out a worker outage
is charged the whole wait (no coordinated omission) — and the fleet's
``fault_events`` are rebased onto the run timeline so the SLO report's
windows show exactly where a chaos kill landed.

``time_scale`` compresses virtual arrival time onto the wall clock
(``time_scale=10`` plays a 60s diurnal period in 6s of wall time);
latencies are always reported in wall seconds.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

from repro_torch.fleet.config import FleetConfig
from repro_torch.obs import clock as obs_clock
from repro_torch.service.arrivals import ArrivalProcess
from repro_torch.service.slo import SLO, SLOEngine
from repro_torch.service.standing import ServeResult, StandingFleet

DEFAULT_SLO = SLO(target_ms=200.0, percentile=0.99)


@dataclass
class LoadReport:
    """Everything one load run produced: the SLO accounting (the
    product), the serve session's per-request records and fold, and the
    run's shape for provenance."""

    slo: Dict                      # SLOEngine.report()
    serve: ServeResult             # records + totals + scaling/recovery
    n_arrivals: int                # requests actually fired
    time_scale: float
    wall_s: float
    stopped: bool = False          # True: cut short by a stop event
    meta: Dict = field(default_factory=dict)
    #: the run's overall LatencySketch (``SLOEngine.overall``) — folds
    #: into the service's /metrics histogram without re-observing
    latency: object = None

    #: schema version of ``to_dict``; bump on any breaking field change
    SCHEMA = 1

    def to_dict(self) -> Dict:
        """JSON-ready summary with a stable schema tag.

        Per-request records are elided; the fleet side goes through the
        one versioned serialization (``ServeResult.fleet_report()`` →
        ``FleetReport.to_json``) instead of a hand-built dict.  The obs
        event timeline is bulky and served by ``/trace`` — here it is
        reduced to its counts."""
        fleet = self.serve.fleet_report().to_json(reports=False)
        obs = dict(fleet.get("obs") or {})
        if "events" in obs:
            obs["n_events"] = len(obs.pop("events"))
        fleet["obs"] = obs
        return {
            "schema": self.SCHEMA,
            "n_arrivals": self.n_arrivals,
            "time_scale": self.time_scale,
            "wall_s": self.wall_s,
            "stopped": self.stopped,
            "n_ok": self.serve.n_ok,
            "n_skipped": self.serve.n_skipped,
            "fleet": fleet,
            "slo": self.slo,
            "meta": self.meta,
        }


def run_load(emulator, arrivals: ArrivalProcess, *,
             config: Optional[FleetConfig] = None,
             standing: Optional[StandingFleet] = None,
             slo: SLO = DEFAULT_SLO, window_s: float = 1.0,
             time_scale: float = 1.0,
             stop: Optional[threading.Event] = None,
             warmup: bool = True) -> LoadReport:
    """Drive one open-loop load run to completion and report.

    Pass ``config`` to build (and tear down) a pool for this run, or
    ``standing`` to reuse a warm one (it stays warm afterwards — the
    offered-load sweep benchmark amortizes one spawn across every rate).
    ``stop`` cuts the arrival loop short; everything already submitted
    still drains and is accounted.
    """
    if time_scale <= 0:
        raise ValueError("time_scale must be > 0")
    if (standing is None) == (config is None):
        raise ValueError("pass exactly one of config= or standing=")
    from repro_torch.scenarios import generate

    owns = standing is None
    if owns:
        standing = StandingFleet(emulator, config)
        if warmup:
            standing.warmup()
    engine = SLOEngine(slo, window_s=window_s)
    t0_box = {}

    def _complete(rec, rep):
        t0 = t0_box["t0"]
        sched = t0 + rec.meta["t"] / time_scale
        engine.observe(t_done=rec.done - t0,
                       latency_s=max(0.0, rec.done - sched),
                       ok=bool(rec.ok))

    unsubscribe = standing.on_complete(_complete)
    stopped = False
    n = 0
    try:
        t0 = t0_box["t0"] = obs_clock.now()
        for a in arrivals:
            due = t0 + a.t / time_scale
            while True:
                lag = due - obs_clock.now()
                if lag <= 0:
                    break
                if stop is not None and stop.wait(min(lag, 0.1)):
                    break
                if stop is None:
                    time.sleep(min(lag, 0.25))
            if stop is not None and stop.is_set():
                stopped = True
                break
            # offered is charged at the *scheduled* instant: offered load
            # is the experiment's independent variable, not a measurement
            engine.offered(a.t / time_scale)
            profile = generate(a.scenario, **a.kwargs)
            standing.submit(profile, meta={"t": a.t, "arrival": a})
            n += 1
        serve = standing.drain() if standing.active else ServeResult(
            records=[], totals=None, serial_s=0.0, n_ok=0, n_skipped=0,
            wall_s=0.0)
        for opened, repaired in serve.recovery.get("fault_events", ()):
            engine.fault(opened - t0, repaired - t0)
        return LoadReport(slo=engine.report(), serve=serve, n_arrivals=n,
                          time_scale=time_scale,
                          wall_s=obs_clock.now() - t0, stopped=stopped,
                          latency=engine.overall)
    finally:
        unsubscribe()
        if owns:
            standing.close()

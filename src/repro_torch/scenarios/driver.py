"""End-to-end scenario driver: generate -> predict -> emulate -> store.

``run_scenario`` pushes one synthesized profile through the paper's whole
lifecycle on machines we do have (emulation atoms) and machines we don't
(roofline prediction via ``predictor.compare``), then persists it to a
``ProfileStore`` under its scenario tags.  ``run_fleet`` does the same for a
batch of scenarios and replays them concurrently through
``Emulator.emulate_many`` with a shared plan cache.  Both emulate on the
card unless given an emulator: ``Emulator()`` runs on ``"cuda"``.
``DEFAULT_SPECS`` are the JAX package's prediction targets, so both
packages predict the same rows.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.core.emulator import (UNSET, EmulationReport, Emulator,
                                       FleetReport)
from repro_torch.core.hardware import (HOST_I7_M620, HOST_STAMPEDE_NODE,
                                       TPU_V5E, HardwareSpec)
from repro_torch.core.metrics import SynapseProfile
from repro_torch.core.predictor import compare, predict_fleet
from repro_torch.core.store import ProfileStore
from repro_torch.scenarios.base import generate

DEFAULT_SPECS = [TPU_V5E, HOST_I7_M620, HOST_STAMPEDE_NODE]


@dataclass
class ScenarioResult:
    name: str
    profile: SynapseProfile
    predictions: Dict[str, Dict]             # hw name -> compare() row
    report: Optional[EmulationReport] = None
    run_id: Optional[str] = None

    def summary(self) -> Dict:
        out = {"scenario": self.name, "n_samples": len(self.profile.samples),
               "gflops": self.profile.totals.flops / 1e9,
               "predictions": self.predictions}
        if self.report is not None:
            out["emulated_ttc_s"] = self.report.ttc_s
        if self.run_id is not None:
            out["run_id"] = self.run_id
        return out


def run_scenario(name: str, *, store: Optional[ProfileStore] = None,
                 specs: Optional[Sequence[HardwareSpec]] = None,
                 emulator: Optional[Emulator] = None, emulate: bool = True,
                 fused: bool = True, **params) -> ScenarioResult:
    """Generate one scenario, predict it across hardware, emulate it here,
    and (optionally) persist it under its scenario tags.  ``fused`` selects
    the schedule-compiler replay path (O(segments) dispatches); pass False
    to force the legacy per-sample loop."""
    profile = generate(name, **params)
    predictions = compare(profile, list(specs or DEFAULT_SPECS))
    profile.meta["predictions"] = predictions    # persisted with the profile
    report = None
    if emulate:
        report = (emulator or Emulator()).emulate(profile, fused=fused)
        profile.meta["emulated_ttc_s"] = report.ttc_s
    run_id = store.add(profile) if store is not None else None
    return ScenarioResult(name=name, profile=profile, predictions=predictions,
                          report=report, run_id=run_id)


@dataclass
class FleetResult:
    results: List[ScenarioResult]
    fleet: FleetReport
    predictions: Dict = field(default_factory=dict)  # predict_fleet() row
    n_streamed: int = 0                  # profiles pulled from ``profiles``


def run_fleet(jobs: Sequence[Tuple[str, Dict]] = (), *,
              profiles: Optional[Iterable[SynapseProfile]] = None,
              store: Optional[ProfileStore] = None,
              hw: HardwareSpec = TPU_V5E,
              specs: Optional[Sequence[HardwareSpec]] = None,
              emulator: Optional[Emulator] = None,
              fused: bool = True, config=None, collect: str = "reports",
              # legacy fleet kwargs — fold into FleetConfig + warning
              max_workers=UNSET, executor=UNSET, mesh_spec=UNSET,
              hosts=UNSET, listen=UNSET, agents=UNSET,
              timeout=UNSET) -> FleetResult:
    """Synthesize and/or pull a fleet of profiles and replay it concurrently.

    ``jobs`` is a sequence of (scenario_name, params) pairs.  ``profiles``
    feeds the fleet from pre-built profiles instead of (or in addition to)
    generators — typically ``ProfileStore.stream(tags)``, the replay-a-
    captured-day path.  The whole pipeline is *lazy end-to-end*: jobs are
    generated/predicted and stored profiles pulled off disk only as the
    fleet's compile-ahead window drains, so a production day streams
    through the executor at bounded coordinator memory instead of being
    drained into a job list first.  Streamed profiles reuse any
    predictions persisted in their meta and are not re-stored (they
    usually came from ``store``); generated profiles are stored only after
    emulation so the persisted meta carries ``emulated_ttc_s`` exactly
    like single ``run_scenario`` calls.

    ``config`` (a ``repro_torch.fleet.FleetConfig``) selects and shapes the
    fleet backend — thread pool, local ``ProcessFleet`` worker processes,
    or a ``RemoteFleet`` of TCP host agents — including the compile-ahead
    ``window`` and ``autoscale`` elasticity; the legacy
    ``executor``/``max_workers``/``mesh_spec``/``hosts``/``listen``/
    ``agents``/``timeout`` kwargs still work but fold into a FleetConfig
    under a DeprecationWarning.  ``collect="totals"`` drops per-profile
    results/reports and returns aggregates only (``FleetResult.results``
    stays empty) — the bounded-memory mode for unbounded streams.
    """
    from repro_torch.fleet.config import FleetConfig
    # fold (and config-validate) before paying generate/predict cost
    cfg = FleetConfig.fold(
        config,
        dict(max_workers=max_workers, executor=executor, mesh_spec=mesh_spec,
             hosts=hosts, listen=listen, agents=agents, timeout=timeout),
        caller="run_fleet")
    if not jobs and profiles is None:
        raise ValueError("run_fleet needs jobs and/or profiles to replay")
    capture = collect == "reports"
    results: List[ScenarioResult] = []   # grows as the fleet pulls
    n_streamed = 0

    def _source():
        nonlocal n_streamed
        for name, params in jobs:
            r = run_scenario(name, emulate=False, specs=specs, **params)
            if capture:
                results.append(r)
            yield r.profile
        for p in (profiles or ()):
            n_streamed += 1
            if capture:
                results.append(
                    ScenarioResult(name=p.tags.get("scenario", p.command),
                                   profile=p,
                                   predictions=p.meta.get("predictions", {})))
            yield p

    em = emulator or Emulator()
    fleet = em.emulate_many(_source(), fused=fused, config=cfg,
                            collect=collect)
    if fleet.n_profiles == 0:
        raise ValueError("run_fleet needs jobs and/or profiles to replay "
                         "(the profile stream was empty)")
    # ReportFold emits reports in source order, so they zip with results
    n_generated = len(jobs)
    for i, (r, rep) in enumerate(zip(results, fleet.reports)):
        r.report = rep
        r.profile.meta["emulated_ttc_s"] = rep.ttc_s
        if store is not None and i < n_generated:
            r.run_id = store.add(r.profile)
    return FleetResult(results=results, fleet=fleet,
                       predictions=predict_fleet(
                           [r.profile for r in results], hw)
                       if capture else {},
                       n_streamed=n_streamed)

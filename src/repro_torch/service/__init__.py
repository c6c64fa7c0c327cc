"""Live traffic emulation service: open-loop load against a warm fleet.

The batch layers below this one (``repro_torch.fleet``) answer "how fast
can the pool drain these profiles?".  This package answers the serving
question instead: "with requests arriving on *their* schedule, what
latency distribution does the emulated system deliver — and what does a
mid-storm fault do to the tail?".

Four pieces, composable from Python or driven over HTTP:

* :mod:`repro_torch.service.arrivals` — seeded deterministic open-loop
  arrival processes (Poisson, constant-rate, diurnal ramp, recorded
  trace); bit-reproducible via the repo's sha256-per-scope seeding
  discipline, and equal to the JAX package's timelines seed for seed.
* :mod:`repro_torch.service.standing` — :class:`StandingFleet`, a
  persistent serve loop over ``FleetBase.stream``'s open-loop admission
  mode: a warm process/remote pool that accepts bundles at arrival time
  and tracks per-request enqueue/dispatch/completion timing.
* :mod:`repro_torch.service.slo` — streaming SLO accounting: bounded
  quantile sketch (p50/p99/p999 in a few hundred ints), goodput vs
  offered load, per-window violations, and chaos attribution (fault MTTR
  windows joined against the latency timeline).
* :mod:`repro_torch.service.load` / :mod:`repro_torch.service.http` —
  ``run_load`` drives one run end to end; ``python -m
  repro_torch.service`` serves it as ``/run?scenario=...`` HTTP
  endpoints returning SLO reports as JSON.

The workers replay on the emulator's device: ``Emulator()`` runs on
``"cuda"``, so pass ``Emulator(device="cpu")`` to serve from the host.

The one-liner::

    from repro_torch.service import PoissonArrivals, SLO, run_load
    report = run_load(em, PoissonArrivals(rate_hz=50, n_requests=500,
                                          scenario="serving_traffic"),
                      config=FleetConfig.process(max_workers=4,
                                                 chaos=ChaosPolicy(
                                                     kill_every=100)),
                      slo=SLO(target_ms=200, percentile=0.99))
    print(report.slo["p999"], report.slo["windows"])
"""
from repro_torch.service.arrivals import (  # noqa: F401
    ARRIVAL_KINDS, Arrival, ArrivalProcess, ConstantArrivals,
    DiurnalArrivals, PoissonArrivals, TraceArrivals, arrival_process)
from repro_torch.service.load import LoadReport, run_load  # noqa: F401
from repro_torch.service.slo import (SLO, LatencySketch,  # noqa: F401
                                     SLOEngine)
from repro_torch.service.standing import (RequestRecord,  # noqa: F401
                                          ServeResult, StandingFleet)

__all__ = [
    "ARRIVAL_KINDS", "Arrival", "ArrivalProcess", "ConstantArrivals",
    "DiurnalArrivals", "PoissonArrivals", "TraceArrivals",
    "arrival_process", "LoadReport", "run_load", "SLO", "LatencySketch",
    "SLOEngine", "RequestRecord", "ServeResult", "StandingFleet",
]

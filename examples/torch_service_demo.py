"""Live traffic emulation demo on PyTorch: a Poisson storm with a kill
mid-run.

Open-loop load (seeded Poisson arrivals) is driven against a standing
1-worker process fleet (on a CUDA card by default) while a seeded
``ChaosPolicy`` kills the worker partway through the storm.  Requests
keep *arriving* during the outage, so by the time the respawned worker is
warm, the queue has a backlog whose wait is the fault's MTTR.  The SLO
report makes that visible: the windows the fault overlaps carry a p999 on
the order of the MTTR, while clean windows sit at replay latency.

    PYTHONPATH=src python examples/torch_service_demo.py [--device cuda|cpu]
"""
import os, sys
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(_ROOT, 'src'), _ROOT]

import argparse

from repro_torch.core import Emulator
from repro_torch.device import cli_device
from repro_torch.fleet import ChaosPolicy, FleetConfig
from repro_torch.service import SLO, PoissonArrivals, run_load


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the worker replays (default: cuda)")
    args = ap.parse_args()
    em = Emulator(device=cli_device(args.device, "torch_service_demo"))
    # ~25 req/s for 40 requests; each worker dies on its 15th dispatch
    arrivals = PoissonArrivals(rate_hz=25.0, n_requests=40,
                               scenario="serving_traffic",
                               params={"n_requests": 2, "n_params": 2e6,
                                       "prefill_tokens": 64,
                                       "decode_tokens": 8},
                               seed=11)
    config = FleetConfig.process(
        max_workers=1,
        chaos=ChaosPolicy(seed=3, kill_every=15, max_faults=1),
        liveness_timeout=5.0, max_respawns=8, timeout=600.0)
    print("driving a Poisson storm (seed 11) against a 1-worker standing "
          "fleet;\nchaos kills the worker on its 15th dispatch (seed 3) ...")
    report = run_load(em, arrivals, config=config,
                      slo=SLO(target_ms=250.0, percentile=0.99),
                      window_s=0.5)

    s = report.slo
    rec = report.serve.recovery
    print(f"\n{report.n_arrivals} arrivals, {report.serve.n_ok} completed, "
          f"{rec.get('worker_deaths', 0)} worker death(s), "
          f"MTTR {rec.get('mttr_s') or 0:.2f}s")
    print(f"overall: p50={s['p50'] * 1e3:8.1f}ms  "
          f"p99={s['p99'] * 1e3:8.1f}ms  p999={s['p999'] * 1e3:8.1f}ms  "
          f"goodput={s['goodput_hz']:.1f}/s of {s['offered_hz']:.1f}/s "
          f"offered")
    print(f"\n{'window':>8s} {'offered':>8s} {'done':>6s} {'p999_ms':>10s} "
          f"{'SLO viol':>9s}  fault?")
    for w in s["windows"]:
        marker = "  <-- kill window" if w["faults"] else ""
        print(f"{w['t0']:7.1f}s {w['offered']:8d} {w['completed']:6d} "
              f"{w['p999'] * 1e3:10.1f} {w['violations']:9d}{marker}")
    spike = max((w["p999"] for w in s["windows"] if w["faults"]),
                default=0.0)
    # "clean" = windows with live offered load and no fault overlap (the
    # offered==0 tail is backlog drain, still paying for the outage)
    clean = [w["p999"] for w in s["windows"]
             if not w["faults"] and w["offered"]]
    print(f"\np999 spike in faulted windows: {spike * 1e3:.0f}ms"
          + (f" vs {max(clean) * 1e3:.0f}ms in clean ones" if clean else ""))


if __name__ == "__main__":
    main()

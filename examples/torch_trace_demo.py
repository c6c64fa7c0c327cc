"""Flight-recorder demo on PyTorch: a chaos storm, exported as a
Perfetto trace.

Replays a small scenario batch on a 2-worker process fleet (on a CUDA
card by default) with a seeded ``ChaosPolicy`` killing a worker every 5th
dispatch, then writes the merged flight-recorder timeline as Chrome
trace-event JSON and re-runs the same seed to show the event sequence is
deterministic.

    PYTHONPATH=src python examples/torch_trace_demo.py [out.json]
        [--device cuda|cpu]

Open the written file at https://ui.perfetto.dev (or chrome://tracing):

* the ``coordinator`` track shows one ``queue b<idx>`` span per bundle
  (enqueue -> dispatch wait);
* each ``worker:N`` track shows ``replay b<idx>`` spans: the bundle the
  kill interrupted appears TWICE, its second span on the rescue worker;
* ``fault_opened`` / ``fault_repaired`` instants bracket the respawn
  (their gap is the MTTR the SLO layer charges);
* ``segments b<idx>`` spans are worker-side, shipped home with results
  and rebased through per-peer clock-offset estimation.
"""
import os, sys
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(_ROOT, 'src'), _ROOT]

import argparse

from repro_torch.core import Emulator
from repro_torch.device import cli_device
from repro_torch.fleet import FleetConfig
from repro_torch.fleet.chaos import ChaosPolicy
from repro_torch.obs.recorder import Event, event_sequence
from repro_torch.obs.trace import to_chrome_trace, write_trace
from repro_torch.scenarios import run_fleet

JOBS = [("serving_traffic", {"n_requests": 3})] * 8


def storm(dev):
    config = FleetConfig.process(
        max_workers=2, window=1,     # window=1: deterministic dispatch
        chaos=ChaosPolicy(seed=3, kill_every=5, max_faults=1),
        liveness_timeout=5.0, on_failure="skip", max_respawns=8,
        timeout=600.0)
    out = run_fleet(JOBS, emulator=Emulator(device=dev), config=config,
                    collect="totals")
    return out.fleet


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("out", nargs="?", default="fleet_trace.json")
    ap.add_argument("--device", default="cuda",
                    help="where the fleet replays (default: cuda)")
    args = ap.parse_args()
    dev = cli_device(args.device, "torch_trace_demo")
    fleet = storm(dev)
    events = [Event.from_dict(d)
              for d in fleet.obs.get("events", ())]
    kinds = sorted({e.kind for e in events})
    print(f"storm: {len(events)} events, kinds: {', '.join(kinds)}")
    rec = fleet.recovery
    print(f"chaos: {rec['worker_deaths']} worker death(s), "
          f"{rec['requeued']} requeue(s)")
    if rec["worker_deaths"] < 1 or not any(e.kind == "fault_opened"
                                           for e in events):
        raise SystemExit("the seeded kill must fire")

    trace = to_chrome_trace(events, meta={"demo": "chaos storm"})
    replay_spans = [t for t in trace["traceEvents"]
                    if t.get("cat") == "replay"]
    per_idx = {}
    for t in replay_spans:
        per_idx.setdefault(t["args"]["idx"], []).append(t)
    rescued = {i: s for i, s in per_idx.items() if len(s) > 1}
    print(f"trace: {len(replay_spans)} replay spans; bundle(s) "
          f"{sorted(rescued)} dispatched twice (killed, then rescued)")
    if not rescued:
        raise SystemExit("the killed bundle must show a second dispatch "
                         "span")
    write_trace(args.out, trace)
    print(f"wrote {args.out} — load it at https://ui.perfetto.dev")

    # same seed, same fleet shape => same event sequence (identity only;
    # every timestamp differs run to run)
    fleet2 = storm(dev)
    events2 = [Event.from_dict(d)
               for d in fleet2.obs.get("events", ())]
    if event_sequence(events) != event_sequence(events2):
        raise SystemExit("the re-run's event sequence differs")
    print("re-ran the storm: event sequence identical (deterministic)")


if __name__ == "__main__":
    main()

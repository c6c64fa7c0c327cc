"""Scenario fleet on PyTorch: synthesize a production mix, replay it
concurrently.

No application is profiled here: every profile is generated by the
scenario engine (training scans, serving traffic, stragglers, retry
storms), predicted across hardware we don't have, replayed as a
concurrent fleet through the shared-plan-cache emulator, and persisted to
a tagged store.  On a CUDA card by default.

PYTHONPATH=src python examples/torch_scenario_fleet.py [--device cuda|cpu]
"""
import os, sys
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(_ROOT, 'src'), _ROOT]

import argparse
import tempfile

from repro_torch.core import Emulator, PlanCache, ProfileStore, TPU_V5E
from repro_torch.device import cli_device
from repro_torch.fleet import FleetConfig, MeshSpec
from repro_torch.scenarios import list_scenarios, run_fleet, run_scenario


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the fleet replays (default: cuda)")
    args = ap.parse_args()
    dev = cli_device(args.device, "torch_scenario_fleet")
    print("registered scenarios:", ", ".join(list_scenarios()))
    with tempfile.TemporaryDirectory(prefix="synapse_fleet_store_") as d:
        run(ProfileStore(d), dev)


def run(store, dev):
    # 1. one scenario end-to-end: generate -> predict -> emulate -> store
    res = run_scenario("serving_traffic", store=store,
                       emulator=Emulator(device=dev), n_requests=6,
                       n_params=2e6, prefill_tokens=64, decode_tokens=8)
    print(f"\nserving_traffic: {len(res.profile.samples)} samples, "
          f"emulated ttc={res.report.ttc_s:.3f}s, stored as {res.run_id}")
    for hw, row in res.predictions.items():
        print(f"  predicted on {hw:16s} ttc_max={row['ttc_max']:.2e}s "
              f"dominant={row['dominant_total']}")

    # 2. a mixed fleet, replayed concurrently with a shared plan cache
    jobs = [
        ("training_scan", dict(n_steps=6, ckpt_every=3, ckpt_bytes=2 << 20)),
        ("training_scan", dict(n_steps=6, ckpt_every=3, ckpt_bytes=2 << 20)),
        ("serving_traffic", dict(n_requests=4, n_params=2e6,
                                 prefill_tokens=64, decode_tokens=8)),
        ("fanout_straggler", dict(n_workers=4, work_flops=2e7,
                                  work_hbm=4e6)),
        ("retry_storm", dict(n_tasks=4, work_flops=2e7, work_hbm=2e6)),
    ]
    em = Emulator(plan_cache=PlanCache(), device=dev)
    out = run_fleet(jobs, store=store, hw=TPU_V5E, emulator=em,
                    config=FleetConfig.thread(max_workers=4))
    f = out.fleet
    print(f"\nfleet: {f.n_profiles} profiles in {f.wall_s:.3f}s "
          f"(per-profile TTCs sum to {f.serial_s:.3f}s, "
          f"est. {f.speedup:.1f}x concurrency)")
    print(f"plan cache: {f.cache_stats['plans_built']} plans built, "
          f"{f.cache_stats['hits']} reused across the fleet")
    print(f"on {out.predictions['hw']}: "
          f"serial={out.predictions['serial_s']:.2e}s "
          f">= concurrent lower bound="
          f"{out.predictions['concurrent_lower_s']:.2e}s")

    # 3. the same fleet on worker PROCESSES: each worker builds a 2-shard
    #    mesh on its device, so the all-reduce legs below execute
    #    (threads drop them: no per-thread mesh)
    coll_jobs = jobs + [("training_scan",
                         dict(n_steps=6, ici_per_step=4e6, ckpt_every=0))]
    out = run_fleet(coll_jobs, emulator=em,
                    config=FleetConfig.process(
                        max_workers=2,
                        mesh=MeshSpec(shape=(2,), axes=("model",))))
    f = out.fleet
    colls = sum(r.report.n_collective_dispatches for r in out.results)
    print(f"\nprocess fleet: {f.n_profiles} profiles in {f.wall_s:.3f}s "
          f"on {f.cache_stats['workers']} workers "
          f"({colls} collective dispatches executed)")

    # 4. everything landed in the store under its scenario tags
    for name in list_scenarios():
        n = len(store.find({"scenario": name}))
        if n:
            print(f"store: scenario={name}: {n} run(s)")


if __name__ == "__main__":
    main()

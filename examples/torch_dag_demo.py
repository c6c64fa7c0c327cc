"""DAG workload demo on PyTorch: a fork-join diamond replayed on the
frontier scheduler, with critical-path accounting and a Perfetto trace
whose flow arrows draw the dependency edges.

Builds a ``dag_diamond_workload`` (source -> 4 branches -> sink, one
branch a seeded 3x straggler), replays it on a 2-worker process fleet
through ``Emulator.emulate_many`` (on a CUDA card by default), and shows
what the structure buys:

* exact totals: the index-order fold equals the workload's analytic
  expectation, edges or no edges;
* ``FleetReport.dag``: critical path vs makespan vs summed work, the
  parallelism ratio, and per-node slack;
* a trace-event JSON with ``ph:"s"/"f"`` flow arrows along every edge.

    PYTHONPATH=src python examples/torch_dag_demo.py [out.json]
        [--device cuda|cpu]

Open the written file at https://ui.perfetto.dev (or chrome://tracing)
and enable "Flow events" to see the diamond drawn across the two worker
tracks.
"""
import os, sys
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(_ROOT, 'src'), _ROOT]

import argparse

from repro_torch.core import Emulator
from repro_torch.device import cli_device
from repro_torch.fleet import FleetConfig
from repro_torch.obs.recorder import Event
from repro_torch.obs.trace import to_chrome_trace, validate_trace, write_trace
from repro_torch.scenarios.dag import dag_diamond_workload

TILE, BLOCK = 64, 1 << 18


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("out", nargs="?", default="dag_trace.json")
    ap.add_argument("--device", default="cuda",
                    help="where the fleet replays (default: cuda)")
    args = ap.parse_args()
    dev = cli_device(args.device, "torch_dag_demo")
    dag = dag_diamond_workload(fanout=4, work_flops=500 * 2.0 * TILE ** 3,
                               work_hbm=2.0 * BLOCK, samples_per=2,
                               straggler_index=1, straggler_factor=3.0)
    print(f"diamond: {len(dag)} nodes, {dag.n_edges} edges, "
          f"parents {dict(dag.parents_map)}")

    em = Emulator(compute_tile=TILE, mem_block=BLOCK, device=dev)
    out = em.emulate_many(dag, config=FleetConfig.process(max_workers=2,
                                                          timeout=600.0))
    if out.totals != dag.totals:
        raise SystemExit("the fold must match the analytic totals")
    print(f"replayed {out.n_replayed} nodes, totals exact: "
          f"{out.totals == dag.totals}")

    cp = out.dag
    print(f"critical path: {cp['critical_path_s']:.3f}s through nodes "
          f"{cp['critical_nodes']} (makespan {cp['makespan_s']:.3f}s, "
          f"summed work {cp['sum_work_s']:.3f}s, "
          f"parallelism {cp['parallelism']:.2f}x)")
    for idx, slack in sorted(cp["slack_s"].items()):
        label = dag.nodes[idx].profile.command
        tag = " <- critical" if idx in cp["critical_nodes"] else ""
        print(f"  node {idx} ({label}): slack {slack:.3f}s{tag}")

    events = [Event.from_dict(d) for d in out.obs.get("events", ())]
    trace = to_chrome_trace(events, meta={"demo": "dag diamond"})
    validate_trace(trace)
    arrows = [t for t in trace["traceEvents"]
              if t.get("cat") == "dag" and t["ph"] == "s"]
    if len(arrows) != dag.n_edges:
        raise SystemExit(f"expected {dag.n_edges} flow arrows, got "
                         f"{len(arrows)}")
    path = write_trace(args.out, trace)
    print(f"{len(arrows)} dependency flow arrows -> {path}")
    print("open at https://ui.perfetto.dev (enable flow events)")


if __name__ == "__main__":
    main()

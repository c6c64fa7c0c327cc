"""One run of one cell: set up, measure for ``--seconds``, read the trace,
check the outputs against the plain reference, print one JSON line.

The line's ``metrics`` hold the cell's end-to-end metrics (``--trace 0``)
or its per-layer metrics (``--trace 1``, the window under
``torch.profiler``).  ``checks``, its last key, holds each number compared
with its limit; they are also the last lines on standard error.  A run
without the cards the cell asks for, or with JAX or the JAX package
loaded at the end, exits non-zero and prints no result.  ``--rehearse``
runs the cell at its tiny rehearsal size on the CPU, prints what it
checked and counted, and exits 3: it reports no card metric.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

#: top-level modules that must not be loaded in a run: JAX and the JAX
#: package the program was ported from (compared by whole names)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

REHEARSAL_EXIT = 3


@dataclass
class Check:
    """One number compared with its limit: correct while value <= limit."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="synbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rehearse", action="store_true",
                    help="tiny size on the CPU; reports no card metric")
    return ap.parse_args(argv)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def set_cache_dirs(root: str) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths
    (the program's own kernel library builds under ``build/repro_torch``
    there)."""
    base = os.path.join(root, "build", "synbench")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = os.path.join(base, sub)


class RunView:
    """What a per-layer metric's reader may read: the runner's facts of
    the window, the trace's timeline (None untraced) and the spans."""

    def __init__(self, facts: Dict, timeline, spans, window_s: float):
        self.facts = facts
        self.timeline = timeline
        self.spans = spans
        self.window_s = window_s


def log(msg: str) -> None:
    """A line of progress on standard error."""
    print(f"synbench: {msg}", file=sys.stderr, flush=True)


def main(argv, t_process: float, root: str) -> int:
    args = parse(argv)
    set_cache_dirs(root)
    sys.path.insert(0, os.path.join(root, "src"))
    from synbench.core import peaks, spec
    from synbench.core.spans import Spans
    cell = spec.resolve(root, args.workload, rehearse=args.rehearse)

    import torch
    chips = int(cell.workload["chips"])
    if args.rehearse:
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < chips:
            found = torch.cuda.device_count() \
                if torch.cuda.is_available() else 0
            log(f"{cell.name} needs {chips} CUDA card(s); found {found}")
            return 2
        device = torch.device("cuda", 0)

    ref = cell.reference()
    runner = cell.runner().Runner(cell, ref, device, args.seed,
                                  args.rehearse)
    log(f"imports done at {time.perf_counter() - t_process:.3f} s")
    runner.setup()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_process
    log(f"set-up done at {setup_s:.3f} s")

    spans = Spans()
    prof = None
    if args.trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CUDA] if device.type == "cuda" else \
            [ProfilerActivity.CPU]
        prof = profile(activities=acts)
        prof.start()
    runner.window(args.seconds, spans)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    timeline = None
    if prof is not None:
        prof.stop()
        if device.type == "cuda":
            from synbench.core.trace import Timeline, device_ops
            timeline = Timeline(device_ops(prof), runner.t0_ns,
                                runner.t1_ns, spans)
        del prof
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0

    e2e = dict(runner.end_to_end())
    e2e["setup_s"] = setup_s
    per_layer: Dict[str, Optional[float]] = {}
    if args.trace:
        view = RunView(runner.facts(), timeline, spans, runner.window_s)
        for m in cell.per_layer:
            per_layer[m["name"]] = spec.load_reader(m["name"]).read(view)

    runner.release()
    checks: List[Check] = runner.checks()
    correct = bool(checks) and all(c.ok for c in checks)
    bad = forbidden_modules()
    if bad:
        log(f"the run loaded {bad}; the benchmark runs the port "
             f"alone")
        return 1
    for c in checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} "
             f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr, flush=True)

    if args.rehearse:
        print(json.dumps({"rehearsal": True, "correct": correct,
                          "attempted": runner.attempted,
                          "failed": runner.failed,
                          "counts": runner.counts(),
                          "checks": result_line(correct, 0, 0, {}, {}, None,
                                                checks)["checks"]}),
              flush=True)
        log("a rehearsal on the CPU reports no card metric")
        return REHEARSAL_EXIT

    if args.trace:
        metrics = {m["name"]: {"value": per_layer[m["name"]],
                               "unit": m["unit"]}
                   for m in cell.per_layer if per_layer[m["name"]] is not None}
    else:
        # a quantity split by cell ("emulate_req_per_s.decode") is the
        # runner's quantity of its base name
        metrics = {m["name"]: {"value": e2e[m["name"]] if m["name"] in e2e
                               else e2e[m["name"].split(".")[0]],
                               "unit": m["unit"]}
                   for m in cell.end_to_end}
    card = peaks.card_line()
    log(f"card {card}; datasheet peaks fp32 {peaks.FP32_FLOPS:.3g} FLOP/s, "
        f"bf16 {peaks.BF16_FLOPS:.3g} FLOP/s, HBM "
        f"{peaks.HBM_BYTES_PER_S:.3g} B/s at {peaks.DATASHEET_WATTS:.0f} W")
    device_info = {"platform": "gpu",
                   "kind": torch.cuda.get_device_name(device),
                   "count": chips, "memory_peak_bytes": int(peak),
                   "card": card}
    breakdown = None
    if timeline is not None:
        device_info["busy_s"] = timeline.busy_s()
        device_info["window_s"] = timeline.window_s
        breakdown = {"device_ops": timeline.by_name(10),
                     "idle_gaps": timeline.idle_gaps(10)}
    print(json.dumps(result_line(correct, runner.attempted, runner.failed,
                                 metrics, device_info, breakdown, checks)),
          flush=True)
    return 0


def result_line(correct: bool, attempted: int, failed: int, metrics: Dict,
                device: Dict, breakdown: Optional[Dict],
                checks: List[Check]) -> Dict:
    """The last line of standard output; ``checks`` comes last."""
    line = {"correct": bool(correct), "attempted": int(attempted),
            "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                      for c in checks}
    return line

#!/usr/bin/env python3
"""Time the MoE router's capacity scan on the card, for one or more trees.

For each ``--src`` (a tree's ``src`` directory, in the order given; name a
tree twice to run it twice), a process of its own imports that tree's
``repro_torch.models.moe`` and calls ``_route`` (router logits, top k, the
one-hot and its cumulative count over the slots that places each token in
its expert's buffer) at Moonlight-16B-A3B's widths (d_model 2048, 64
experts, top-6) on bfloat16 inputs drawn from ``--seed``, at the shapes the
families phase of ``chip_smoke.py`` routes: a prefill of 4 x 2048 tokens
and a decode step of 4 x 1.  Prints one JSON line a tree and shape: the
device time of ``_route`` a call (CUDA events, median of ``--reps``), and
from ``torch.profiler`` each kernel's device time a call, with the scan's
kernels (names holding "scan") summed as ``scan_ms``; ``null`` where the
profiler saw no device time.  The card's name and power limit lead.

    python3 tools/moe_scan_times.py --src build/parent/src --src src \\
        --src src --src build/parent/src
"""
import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r"""
import json, statistics, sys
import torch
from repro_torch.configs import get_config
from repro_torch.models import moe
reps, seed, src = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
cfg = get_config("moonshot-v1-16b-a3b")
dev = torch.device("cuda")
g = torch.Generator(dev).manual_seed(seed)
d, e = cfg.d_model, cfg.moe.num_experts
router = (torch.randn((d, e), generator=g, device=dev) * d ** -0.5) \
    .to(torch.bfloat16)
for name, (b, s) in (("prefill", (4, 2048)), ("decode", (4, 1))):
    x = torch.randn((b, s, d), generator=g, device=dev).to(torch.bfloat16)
    for _ in range(3):
        moe._route(router, x, cfg)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        z = torch.cuda.Event(enable_timing=True)
        a.record()
        moe._route(router, x, cfg)
        z.record()
        z.synchronize()
        times.append(a.elapsed_time(z))
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    calls = 10
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            moe._route(router, x, cfg)
        torch.cuda.synchronize()
    kernels = {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            kernels[ev.key[:160]] = getattr(
                ev, "self_device_time_total",
                getattr(ev, "self_cuda_time_total", 0)) / 1e3 / calls
    scan = [v for k, v in kernels.items() if "scan" in k.lower()]
    _, _, _, _, pos, _, oh = moe._route(router, x, cfg)
    print(json.dumps({
        "src": src, "shape": name, "tokens": [b, s],
        "route_ms": statistics.median(times), "route_ms_all": times,
        "scan_ms": sum(scan) if scan else None, "kernels_ms": kernels,
        "one_hot_dtype": str(oh.dtype), "pos_dtype": str(pos.dtype)}),
        flush=True)
"""


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", action="append", required=True,
                    help="a tree's src directory (repeatable)")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(json.dumps({"card": card.stdout.strip()}), flush=True)
    rc = 0
    for src in args.src:
        src = os.path.abspath(os.path.join(HERE, src))
        env = dict(os.environ, PYTHONPATH=src)
        out = subprocess.run(
            [sys.executable, "-c", CHILD, str(args.reps), str(args.seed),
             src], env=env, capture_output=True, text=True, timeout=600)
        sys.stdout.write(out.stdout)
        if out.returncode:
            sys.stderr.write(out.stderr[-4000:])
            rc = out.returncode
    sys.exit(rc)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Time the float32 flash-attention kernel at the serving shape on one card.

Builds the kernel library of one ``src`` tree, checks its float32 flash
kernel against the plain version at the serving shape (B 4, S 2048, 28
query and 4 KV heads, hd 128, causal; inputs from seed 0) within the
float32 tolerance, 2e-5, then times it: a CUDA graph of 20 launches
replayed between CUDA events, several rounds.  Prints one JSON line: each
round's ms a launch, their median, the share of the float32 FMA bound
(1.2032e11 flops at 67 TFLOP/s, 1.80 ms), the error, and the card's name
and power limit.

    python3 tools/flash_f32_times.py [--src PATH] [--rounds N]

``--src`` names the ``src`` directory whose ``repro_torch`` is timed
(default: this checkout's), so that two checkouts can be compared in one
call on one card, in turns.  Exits non-zero without a card or when the
kernel leaves the tolerance.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys

B, S, HQ, HK, HD = 4, 2048, 28, 4, 128
STEPS = 20
TOL = 2e-5
PEAK_FP32_FLOPS = 67e12


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args()
    src = os.path.abspath(args.src)
    sys.path.insert(0, src)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("flash_f32_times: no CUDA device is available")
    import repro_torch
    if not os.path.abspath(repro_torch.__file__).startswith(src):
        raise SystemExit(f"imported {repro_torch.__file__}, not from {src}")
    from repro_torch.kernels.flash_attention import kernel as fk, ref as fref

    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(0)
    q = torch.randn(B * HQ, S, HD, device=dev, generator=g)
    k = torch.randn(B * HK, S, HD, device=dev, generator=g)
    v = torch.randn(B * HK, S, HD, device=dev, generator=g)
    G = HQ // HK

    def call():
        return fk.flash_attention(q, k, v, block_q=512, block_kv=1024,
                                  group=G)

    got = call()
    want = fref.flash_attention(q, k, v, group=G)
    err = (got - want).abs().max().item()
    if not torch.allclose(got, want, atol=TOL, rtol=TOL):
        raise SystemExit(f"flash_f32_times: max abs err {err} beyond {TOL}")
    del got, want

    def steps():
        for _ in range(STEPS):
            out = call()
        return out

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        steps()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        steps()
    graph.replay()
    torch.cuda.synchronize()
    rounds = []
    for _ in range(args.rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        rounds.append(start.elapsed_time(end) / STEPS)
    ms = statistics.median(rounds)
    flops = fref.flops(B * HQ, S, S, HD, causal=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({
        "src": src, "card": card.strip(), "rounds_ms": rounds, "ms": ms,
        "bound_ms": flops / PEAK_FP32_FLOPS * 1e3,
        "share_of_bound": flops / PEAK_FP32_FLOPS * 1e3 / ms,
        "achieved_tflops": flops / (ms * 1e-3) / 1e12,
        "max_abs_err": err}), flush=True)


if __name__ == "__main__":
    main()

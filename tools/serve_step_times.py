#!/usr/bin/env python3
"""Time Qwen2-7B's bf16 prefill and decode steps on one CUDA card.

Serves the traffic of ``chip_smoke.py``'s serve phase (Qwen2-7B at its
published widths and depth, random bf16 weights from seed 0, 4 prompts of
2048, 1536, 1024 and 512 tokens, 16 new tokens each, flash attention)
through the port's ``Engine`` for several rounds, and prints one JSON
line: each round's prefill ms and decode ms a step, their medians, the
flash launches a round, and the card's name and power limit.

    python3 tools/serve_step_times.py [--src PATH] [--rounds N]

``--src`` names the ``src`` directory whose ``repro_torch`` is timed
(default: this checkout's), so that two checkouts can be compared in one
call on one card, in turns.  Exits non-zero without a card.
"""
import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

PROMPTS = (2048, 1536, 1024, 512)
NEW_TOKENS = 16


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args()
    src = os.path.abspath(args.src)
    sys.path.insert(0, src)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("serve_step_times: no CUDA device is available")
    import repro_torch
    if not os.path.abspath(repro_torch.__file__).startswith(src):
        raise SystemExit(f"imported {repro_torch.__file__}, not from {src}")
    from repro_torch.configs import get_config
    from repro_torch.configs.run import SERVE_RUN
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.models.model_zoo import build_model
    from repro_torch.serve.engine import Engine, Request
    torch.backends.cuda.matmul.allow_tf32 = False

    dev = torch.device("cuda")
    cfg = get_config("qwen2-7b")
    model = build_model(cfg, dataclasses.replace(SERVE_RUN,
                                                 attn_impl="cuda"))
    params = model.init(torch.Generator(dev).manual_seed(0), dev)
    engine = Engine(model, params, batch_slots=len(PROMPTS),
                    max_len=max(PROMPTS) + NEW_TOKENS)
    rng = np.random.default_rng(2)
    prompts = [list(rng.integers(0, cfg.vocab_size, n)) for n in PROMPTS]
    times = {"prefill": [], "decode": []}

    def timed(fn, key):
        def run(*a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a)
            torch.cuda.synchronize()
            times[key].append(time.perf_counter() - t0)
            return out
        return run

    engine.serve([Request(prompt=p, max_new_tokens=2) for p in prompts])
    engine.prefill = timed(engine.prefill, "prefill")
    engine.decode = timed(engine.decode, "decode")
    rounds = []
    for _ in range(args.rounds):
        times["prefill"].clear()
        times["decode"].clear()
        fk.launches = 0
        engine.serve([Request(prompt=p, max_new_tokens=NEW_TOKENS)
                      for p in prompts])
        rounds.append({"prefill_ms": times["prefill"][0] * 1e3,
                       "decode_ms": statistics.median(times["decode"]) * 1e3,
                       "flash_launches": fk.launches})
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({
        "src": src, "card": card.strip(), "rounds": rounds,
        "prefill_ms": statistics.median(r["prefill_ms"] for r in rounds),
        "decode_ms": statistics.median(r["decode_ms"] for r in rounds)}),
        flush=True)


if __name__ == "__main__":
    main()

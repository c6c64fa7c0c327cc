#!/usr/bin/env python3
"""Time Qwen2-7B's training step, cut to 4 layers, on one CUDA card.

Trains the model of ``chip_smoke.py``'s train phase (Qwen2-7B at its
published widths, 4 layers, random weights from seed 0, ``TRAIN_RUN``,
one sequence of 4096 tokens, AdamW) for a warm-up step and several timed
steps on fresh batches, and prints one JSON line: each step's ms, their
median, the peak of allocated memory, and the card's name and power
limit.

    python3 tools/train_step_times.py [--src PATH] [--steps N]

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

LAYERS, SEQ = 4, 4096


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args()
    src = os.path.abspath(args.src)
    sys.path.insert(0, src)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("train_step_times: no CUDA device is available")
    import repro_torch
    if not os.path.abspath(repro_torch.__file__).startswith(src):
        raise SystemExit(f"imported {repro_torch.__file__}, not from {src}")
    from repro_torch.configs import get_config
    from repro_torch.configs.run import TRAIN_RUN
    from repro_torch.models.model_zoo import build_model
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train.step import init_train_state, make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False

    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config("qwen2-7b"), num_layers=LAYERS)
    model = build_model(cfg, TRAIN_RUN)
    state = init_train_state(model, torch.Generator(dev).manual_seed(0),
                             device=dev)
    step = make_train_step(model, OptConfig())
    gen = torch.Generator(dev).manual_seed(1)

    def batch():
        toks = torch.randint(0, cfg.vocab_size, (1, SEQ + 1), generator=gen,
                             device=dev, dtype=torch.int32)
        return {"tokens": toks[:, :-1].contiguous(),
                "targets": toks[:, 1:].contiguous()}

    state, met = step(state, batch())                 # warm-up
    met["loss"].item()
    torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for _ in range(args.steps):
        b = batch()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met = step(state, b)
        met["loss"].item()
        times.append(time.perf_counter() - t0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({
        "src": src, "card": card.strip(), "layers": LAYERS, "seq": SEQ,
        "step_ms": [t * 1e3 for t in times],
        "median_step_ms": statistics.median(times) * 1e3,
        "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
        "loss": float(met["loss"])}), flush=True)


if __name__ == "__main__":
    main()

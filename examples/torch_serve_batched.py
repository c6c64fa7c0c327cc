"""Batched serving of a small LM on PyTorch: prefill + greedy decode over
request waves, profiled by the Synapse runtime watchers.  On a CUDA card
by default.

PYTHONPATH=src python examples/torch_serve_batched.py [--device cuda|cpu]
"""
import os, sys
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(_ROOT, 'src'), _ROOT]

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.run import RunConfig
from repro_torch.core import RuntimeProfiler
from repro_torch.device import cli_device
from repro_torch.models.model_zoo import build_model
from repro_torch.serve.engine import Engine, Request


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where to serve (default: cuda)")
    args = ap.parse_args()
    dev = cli_device(args.device, "torch_serve_batched")
    cfg = reduced_config(get_config("qwen2-1.5b"))
    run = RunConfig(param_dtype="float32", compute_dtype="float32",
                    cache_dtype="float32", remat="none")
    model = build_model(cfg, run)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    engine = Engine(model, params, batch_slots=4, max_len=64, device=dev)

    rng = np.random.default_rng(0)
    reqs = [Request(prompt=list(rng.integers(0, cfg.vocab_size, size=n)),
                    max_new_tokens=8)
            for n in (5, 9, 3, 7, 4, 6)]

    prof = RuntimeProfiler(sample_rate=20).profile_callable(
        lambda: engine.serve(reqs), command="serve-batched")
    for i, r in enumerate(reqs):
        if len(r.out_tokens) != r.max_new_tokens:
            raise SystemExit(f"req{i}: {len(r.out_tokens)} tokens, want "
                             f"{r.max_new_tokens}")
        print(f"req{i}: prompt_len={len(r.prompt)} out={r.out_tokens}")
    print(f"\nserved {len(reqs)} requests in {prof.meta['wall_s']:.2f}s "
          f"({len(prof.samples)} profile samples)")


if __name__ == "__main__":
    main()

"""Quickstart on PyTorch: profile once, emulate anywhere.

Profiles a real (tiny) LM training step with the runtime watchers, then
statically with ``profile_step`` (the operator counter, run on meta
tensors: exact resource counts, no launch, no memory), stores the
profile, replays it through the emulation atoms, and predicts its TTC on
a TPU v5e chip we don't have.  On a CUDA card by default.

PYTHONPATH=src python examples/torch_quickstart.py [--device cuda|cpu]
"""
import os, sys
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(_ROOT, 'src'), _ROOT]

import argparse
import tempfile

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.run import RunConfig
from repro_torch.core import (Emulator, ProfileStore, RuntimeProfiler,
                              TPU_V5E, calibrate, predict, profile_step)
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.device import cli_device, sync
from repro_torch.models.model_zoo import build_model
from repro_torch.models.params import PDef
from repro_torch.optim.adamw import OptConfig, init_opt_state
from repro_torch.train.step import init_train_state, make_train_step


def tiny_train_workload(device, num_layers=3, d_model=128, vocab=256,
                        seq=128, batch=8, steps=1):
    """A small real LM train function on ``device``: the 'application'
    Synapse profiles (the JAX package's benchmark helper of that name)."""
    cfg = ModelConfig(name=f"bench-lm-{num_layers}x{d_model}", family="dense",
                      num_layers=num_layers, d_model=d_model, num_heads=4,
                      num_kv_heads=2, head_dim=max(d_model // 4, 8),
                      d_ff=d_model * 2, vocab_size=vocab, tie_embeddings=True)
    run = RunConfig(param_dtype="float32", compute_dtype="float32",
                    remat="none", loss_chunk=0)
    model = build_model(cfg, run)
    data = SyntheticLM(DataConfig(vocab_size=vocab, seq_len=seq,
                                  global_batch=batch), device=device)
    step = make_train_step(model, OptConfig())
    state = init_train_state(
        model, torch.Generator(device=device).manual_seed(0), device=device)
    batches = [data.batch_at(i) for i in range(steps)]

    # warm up outside the profiled region (we profile steady state)
    state, _ = step(state, batches[0])
    sync(state["opt"]["step"])
    holder = {"state": state}

    def run_fn():
        s = holder["state"]
        for b in batches:
            s, _ = step(s, b)
        sync(s["opt"]["step"])
        holder["state"] = s

    meta = {"cfg": cfg, "model": model, "step": step, "steps": steps,
            "tokens_per_step": seq * batch}
    return run_fn, meta


def _meta_tree(tree, dtype):
    if isinstance(tree, PDef):
        return torch.empty(tree.shape, dtype=tree.dtype or dtype,
                           device="meta")
    return {k: _meta_tree(v, dtype) for k, v in tree.items()}


def _abstract_state(model):
    """The train state as meta tensors: shapes and dtypes, no memory."""
    params = _meta_tree(model.pdefs, model.run.pdtype)
    return {"params": params, "opt": init_opt_state(params)}


def _abstract_batch(meta):
    B, S = 4, 64
    return {k: torch.empty((B, S), dtype=torch.int32, device="meta")
            for k in ("tokens", "targets")}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where to train and emulate (default: cuda)")
    args = ap.parse_args()
    dev = cli_device(args.device, "torch_quickstart")
    run_fn, meta = tiny_train_workload(dev, steps=4)

    # 1. profile (runtime watchers observe the black-box run)
    prof = RuntimeProfiler(sample_rate=20).profile_callable(
        run_fn, command="quickstart-lm", tags={"steps": "4"},
        flops_per_cpu_s=calibrate(device=dev).flops_per_s)
    print(f"profiled: wall={prof.meta['wall_s']:.3f}s "
          f"samples={len(prof.samples)} peak_mem="
          f"{prof.totals.peak_mem_bytes/1e6:.0f}MB")

    # ... and statically from one step on meta tensors (exact counts)
    sprof, _ = profile_step(meta["step"], _abstract_state(meta["model"]),
                            _abstract_batch(meta),
                            command="quickstart-lm-static", device="meta")
    print(f"static:   flops/step={sprof.totals.flops:.3e} "
          f"ici={sprof.totals.ici_total:.3e}B samples={len(sprof.samples)}")

    # 2. store (tagged, statistical over repeats)
    with tempfile.TemporaryDirectory() as d:
        store = ProfileStore(d)
        store.add(prof)
        print(f"stored:   {store.keys()}")

    # 3. emulate anywhere (this device here)
    rep = Emulator(device=dev).emulate(sprof)
    print(f"emulated: ttc={rep.ttc_s:.3f}s flops={rep.consumed.flops:.3e}")

    # 4. predict TTC on hardware we don't have
    pred = predict(sprof, TPU_V5E)
    print(f"tpu v5e:  step={pred.ttc_max*1e6:.1f}us "
          f"dominant={pred.terms.dominant}")


if __name__ == "__main__":
    main()

"""Train an LM for a few hundred steps under full fault tolerance
(checkpoints, an injected failure and restart, the straggler watch) with
the PyTorch port, profile two steady steps with Synapse's runtime
watchers, and replay that profile on the emulator beside the measured time
— the paper's "profile a live train job", on a CUDA card by default.

PYTHONPATH=src python examples/torch_train_with_synapse.py [--steps 200]
    [--big] [--device cuda|cpu]
"""
import os, sys
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(_ROOT, 'src'), _ROOT]

import argparse
import tempfile
import time

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.run import RunConfig
from repro_torch.core import Emulator, RuntimeProfiler, calibrate
from repro_torch.data.pipeline import DataConfig
from repro_torch.device import cli_device, sync
from repro_torch.optim.adamw import OptConfig
from repro_torch.runtime.supervisor import FailurePlan, SupervisorConfig
from repro_torch.train.loop import make_job, train


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--big", action="store_true",
                    help="~100M params (slow on the CPU)")
    ap.add_argument("--device", default="cuda",
                    help="where to train and emulate (default: cuda)")
    args = ap.parse_args()
    dev = cli_device(args.device, "torch_train_with_synapse")

    if args.big:  # ~100M param configuration
        cfg = ModelConfig(name="lm-100m", family="dense", num_layers=8,
                          d_model=768, num_heads=12, num_kv_heads=4,
                          head_dim=64, d_ff=2048, vocab_size=32768,
                          tie_embeddings=True)
        data = DataConfig(vocab_size=32768, seq_len=256, global_batch=8)
    else:
        cfg = ModelConfig(name="lm-3m", family="dense", num_layers=4,
                          d_model=128, num_heads=4, num_kv_heads=2,
                          head_dim=32, d_ff=512, vocab_size=4096,
                          tie_embeddings=True)
        data = DataConfig(vocab_size=4096, seq_len=128, global_batch=8)

    run = RunConfig(param_dtype="float32", compute_dtype="float32",
                    remat="none", loss_chunk=0)
    with tempfile.TemporaryDirectory() as ckpt_dir:
        job = make_job(cfg, run, opt=OptConfig(lr=1e-2, warmup_steps=20,
                                               decay_steps=args.steps * 2,
                                               weight_decay=0.0),
                       data_cfg=data, ckpt_dir=ckpt_dir,
                       sup_cfg=SupervisorConfig(ckpt_every=50,
                                                straggler_tolerance=4.0),
                       device=dev)
        plan = FailurePlan(fail_at_steps={args.steps // 2:
                                          "injected_node_loss"})
        t0 = time.time()
        out = train(job, args.steps, resume=False, failure_plan=plan)
        wall = time.time() - t0
    rep = out["report"]
    print(f"\nmodel={cfg.name} params={job.model.num_params()/1e6:.1f}M "
          f"device={dev}")
    print(f"loss: {np.mean(out['losses'][:5]):.3f} -> "
          f"{np.mean(out['losses'][-5:]):.3f} over {len(out['losses'])} steps")
    print(f"wall={wall:.1f}s restarts={rep.restarts} "
          f"restored_from={rep.restored_from} "
          f"stragglers={len(rep.straggler_events)}")
    assert rep.restarts == 1 and np.mean(out["losses"][-5:]) < \
        np.mean(out["losses"][:5])
    print("OK: survived failure, resumed from checkpoint, converged.")

    # profile two steady steps, then emulate them from the profile
    state = out["state"]

    def two_steps():
        nonlocal state
        for s in (args.steps, args.steps + 1):
            state, met = job.step_fn(state, job.data.batch_at(s))
            sync(met["loss"])

    host = calibrate(device="cpu")
    prof = RuntimeProfiler(sample_rate=20).profile_callable(
        two_steps, command=f"train-{cfg.name}",
        flops_per_cpu_s=host.flops_per_s)
    em = Emulator(calib=calibrate(device=dev), device=dev)
    emu = em.emulate(prof)
    print(f"profiled {prof.meta['wall_s']:.3f}s over 2 steps; emulated "
          f"ttc={emu.ttc_s:.3f}s ({emu.mode}, {emu.n_dispatches} "
          f"dispatches)")


if __name__ == "__main__":
    main()

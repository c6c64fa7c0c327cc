"""Training-scan scenario: a steady layer-scan loop with checkpoint bursts.

The canonical LM-training shape the rest of the repo profiles for real
(``benchmarks.common.tiny_train_workload``), but synthesized: ``n_steps``
identical compute+memory samples — exactly the consecutive-identical-sample
pattern the emulator collapses and the fleet plan cache dedups — with a
storage-write burst every ``ckpt_every`` steps (the checkpoint leg runs on
the emulator's I/O worker thread, concurrent with the device-side atoms,
like the real async checkpointer in ``repro_torch.checkpoint``).
"""
from __future__ import annotations

from repro_torch.core.metrics import ResourceVector, Sample, SynapseProfile
from repro_torch.scenarios.base import register


@register("training_scan",
          n_steps=8, flops_per_step=6e7, hbm_per_step=1.6e7,
          ici_per_step=0.0, ckpt_every=4, ckpt_bytes=4e6)
def training_scan(n_steps: int, flops_per_step: float, hbm_per_step: float,
                  ici_per_step: float, ckpt_every: int,
                  ckpt_bytes: float) -> SynapseProfile:
    """Repeated identical train steps with periodic checkpoint-write bursts."""
    if n_steps < 1:
        raise ValueError("training_scan needs n_steps >= 1")
    samples = []
    n_ckpts = 0
    for i in range(n_steps):
        is_ckpt = ckpt_every > 0 and (i + 1) % ckpt_every == 0
        n_ckpts += is_ckpt
        ici = {"all-reduce": float(ici_per_step)} if ici_per_step > 0 else {}
        rv = ResourceVector(
            flops=float(flops_per_step), hbm_bytes=float(hbm_per_step),
            ici_bytes=ici,
            storage_write_bytes=float(ckpt_bytes) if is_ckpt else 0.0)
        samples.append(Sample(index=i, resources=rv,
                              label="step+ckpt" if is_ckpt else "step"))
    return SynapseProfile(command="scenario:training_scan", samples=samples,
                          meta={"n_ckpts": n_ckpts})

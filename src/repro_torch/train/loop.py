"""End-to-end training loop: data -> supervised step -> checkpoints, with
the Synapse runtime watchers around it (profile-as-you-train) and the
predictor feeding the straggler deadline.

On a mesh (a ``DeviceMesh`` over the ranks of a process group, each rank
running this loop), the state is laid out by ``train_state_specs``: the
initial one through ``models.params.place``, a restored one (a resume,
the supervisor's restart) through the checkpoint's elastic restore.
Every rank draws the same global batch, and the step keeps the rank's
rows of it.
"""
from __future__ import annotations

import tempfile
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.run import RunConfig
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.device import DeviceLike, resolve
from repro_torch.models.model_zoo import Model, build_model
from repro_torch.models.params import map_tensors, place
from repro_torch.optim.adamw import OptConfig
from repro_torch.optim.compression import Int8ErrorFeedback
from repro_torch.parallel.sharding import (TRAIN_RULES, NamedSharding,
                                           make_rules, whole)
from repro_torch.runtime.supervisor import (FailurePlan, Supervisor,
                                            SupervisorConfig)
from repro_torch.train.step import (init_train_state, make_train_step,
                                    train_state_specs)


@dataclass
class TrainJob:
    model: Model
    data: SyntheticLM
    step_fn: Any
    ckpt: CheckpointManager
    supervisor: Supervisor
    device: torch.device
    mesh: Any = None
    #: the state's ``NamedSharding`` tree on ``mesh`` (None without one)
    shardings: Any = None


def make_job(cfg: ModelConfig, run: RunConfig, *, opt: OptConfig = OptConfig(),
             data_cfg: Optional[DataConfig] = None,
             ckpt_dir: Optional[str] = None, mesh=None,
             sup_cfg: Optional[SupervisorConfig] = None,
             compress: bool = False, device: DeviceLike = None) -> TrainJob:
    """A job on ``device`` (``"cuda"`` unless named; on a ``mesh``, the
    rank's device); checkpoints go under ``ckpt_dir`` (a new temporary
    directory when None; on a mesh, one the ranks share).  Gradients are
    compressed only when ``compress`` is set: ``run.grad_compression`` is
    not read, as in the JAX package."""
    dev = resolve(device)
    model = build_model(cfg, run)
    data = SyntheticLM(data_cfg or DataConfig(
        vocab_size=cfg.vocab_size, seq_len=512, global_batch=8), device=dev)
    compressor = Int8ErrorFeedback() if compress else None
    step = make_train_step(model, opt, mesh, compress=compressor)
    shardings = None
    if mesh is not None:
        specs = train_state_specs(model, mesh, make_rules(mesh, TRAIN_RULES),
                                  compressor)
        shardings = map_tensors(specs, lambda s: NamedSharding(mesh, s))
    sup_cfg = sup_cfg or SupervisorConfig()
    ckpt = CheckpointManager(ckpt_dir or tempfile.mkdtemp(prefix="ckpt"),
                             keep=sup_cfg.keep, device=dev)
    sup = Supervisor(ckpt, sup_cfg)
    return TrainJob(model=model, data=data, step_fn=step, ckpt=ckpt,
                    supervisor=sup, device=dev, mesh=mesh,
                    shardings=shardings)


def train(job: TrainJob, num_steps: int, *, rng_seed: int = 0,
          resume: bool = True, failure_plan: Optional[FailurePlan] = None,
          compress: bool = False) -> Dict:
    """Runs ``num_steps`` supervised steps, from the latest checkpoint when
    ``resume`` finds one, else from parameters drawn on the job's device
    from a generator seeded with ``rng_seed`` (on a mesh, every rank draws
    the same and keeps its shards)."""
    start = 0

    def restore(step=None):
        return job.ckpt.restore(step, shardings=job.shardings)

    if resume and job.ckpt.latest_step() is not None:
        state, extra = restore()
        start = extra.get("step", job.ckpt.latest_step())
    else:
        gen = torch.Generator(job.device).manual_seed(rng_seed)
        state = init_train_state(
            job.model, gen, device=job.device,
            compress=Int8ErrorFeedback() if compress else None)
        if job.mesh is not None:
            state = place(state, job.mesh, map_tensors(
                job.shardings, lambda s: s.spec))

    losses = []

    def step_fn(state, batch):
        state, metrics = job.step_fn(state, batch)
        losses.append(_scalar(metrics["loss"]))
        return state, metrics

    # the supervisor takes the only reference to the state: the step updates
    # it in place, so a reference kept here would hold the failed run's
    # tensors on the device after a restore
    held = [state]
    del state
    state, metrics = job.supervisor.run(
        state=held.pop(), step_fn=step_fn,
        batch_fn=lambda s: job.data.batch_at(s),
        num_steps=num_steps, start_step=start, failure_plan=failure_plan,
        restore_fn=lambda s: restore(s)[0],
        extra_fn=lambda s: {"data": job.data.state(s)})
    return {"state": state, "losses": losses,
            "final_metrics": {k: _scalar(v) for k, v in metrics.items()},
            "report": job.supervisor.report}


def _scalar(x) -> float:
    """A metric as a float on every rank (a DTensor's whole value)."""
    return float(whole(x))

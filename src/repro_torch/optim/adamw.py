"""AdamW with a cosine schedule and global-norm clipping: the JAX package's
arithmetic over dicts of tensors (not ``torch.optim.AdamW``, whose state
layout and clipping differ).  The state is ``{"mu", "nu", "step"}`` with
the JAX package's leaf names, so a checkpoint crosses between the two.

``adamw_update`` updates the parameters, ``mu`` and ``nu`` in place, leaf
by leaf, with the JAX package's rounding at every step: on one card a
functional update of a 2e9-parameter state would hold a second copy of
parameters, moments and clipped gradients (32 GB).  ZeRO-1 (``zero1_specs``) comes with the
sharding slice (ROADMAP.md queue 1, item 7h).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Iterator

import torch

from repro_torch.models.params import map_tensors


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def tree_leaves(tree) -> Iterator[torch.Tensor]:
    """Leaves in sorted key order, as ``jax.tree.leaves`` walks a dict."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k])
    else:
        yield tree


def lr_at(cfg: OptConfig, step):
    """Linear warmup then cosine decay (an f32 scalar tensor)."""
    step = torch.as_tensor(step).float()
    warm = cfg.lr * torch.clamp((step + 1) / max(cfg.warmup_steps, 1),
                                max=1.0)
    t = torch.clamp((step - cfg.warmup_steps) /
                    max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cfg.lr * cos)


def init_opt_state(params) -> Dict[str, Any]:
    def zeros(t):
        return map_tensors(t, lambda x: torch.zeros(
            x.shape, dtype=torch.float32, device=x.device))
    step = torch.zeros((), dtype=torch.int32,
                       device=next(tree_leaves(params)).device)
    return {"mu": zeros(params), "nu": zeros(params), "step": step}


def global_norm(tree) -> torch.Tensor:
    leaves = [x.float().square().sum() for x in tree_leaves(tree)]
    return torch.sqrt(torch.stack(leaves).sum())


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return map_tensors(grads, lambda g: g * scale.to(g.dtype)), norm


def adamw_update(grads, opt_state, params, cfg: OptConfig):
    """Returns (params, opt_state, metrics): ``params`` and the state's
    ``mu``/``nu`` updated in place, a new ``step``.  The clipped gradient
    of ``clip_by_global_norm`` is formed one leaf at a time, so the update
    holds at most three leaf-sized temporaries."""
    step = opt_state["step"]
    grads = map_tensors(grads, lambda g: g.float())
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    lr = lr_at(cfg, step)
    s1 = step.float() + 1
    c1 = 1 - torch.pow(cfg.b1, s1)
    c2 = 1 - torch.pow(cfg.b2, s1)
    with torch.no_grad():
        for p, g, m, n in zip(tree_leaves(params), tree_leaves(grads),
                              tree_leaves(opt_state["mu"]),
                              tree_leaves(opt_state["nu"])):
            g = g * scale
            m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
            n.mul_(cfg.b2).add_(g.square_().mul_(1 - cfg.b2))
            denom = (n / c2).sqrt_().add_(cfg.eps)
            upd = (m / c1).div_(denom)
            del g, denom
            p32 = p.float()
            if cfg.weight_decay:
                upd.add_(cfg.weight_decay * p32)
            p32.sub_(upd.mul_(lr))
            if p32 is not p:
                p.copy_(p32)
    new_state = {"mu": opt_state["mu"], "nu": opt_state["nu"],
                 "step": step + 1}
    return params, new_state, {"grad_norm": gnorm, "lr": lr}

"""Train step factory: forward + chunked CE + AdamW, with microbatched
gradient accumulation (the JAX package's ``train/step.py``).

The step is a function ``(state, batch) -> (state, metrics)``.  Parameters
and moments are updated in place (``optim.adamw.adamw_update``) and the
returned state dict holds the same tensors; a checkpoint snapshot copies
them.  Its sharding (``train_state_specs``, ``abstract_train_state``) comes
with the sharding slice (ROADMAP.md queue 1, item 7h).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models.model_zoo import Model
from repro_torch.models.params import cast_tree, map_tensors
from repro_torch.optim.adamw import OptConfig, adamw_update, init_opt_state
from repro_torch.train.loss import cross_entropy

AUX_LOSS_KEYS = ("moe_load_balance", "moe_router_z")


def make_loss_fn(model: Model):
    def loss_fn(params, batch):
        # Mixed precision: f32 master params cast to the compute dtype ONCE,
        # before the layer loop; the cast is differentiable, so gradients
        # reach the f32 master leaves.
        params_c = cast_tree(params, model.run.cdtype)
        hidden, _, aux = model.forward(params_c, batch)
        ce, metrics = cross_entropy(
            lambda h: model.logits(params_c, h), hidden, batch["targets"],
            model.run.loss_chunk)
        loss = ce
        for k in AUX_LOSS_KEYS:
            if k in aux:
                loss = loss + aux[k]
        metrics.update(aux)
        metrics["ce_loss"] = ce
        return loss, metrics
    return loss_fn


def _split_microbatches(batch, m: int):
    def resh(x):
        # batch dim may be axis 0 ([B,...]) or axis 1 ([3,B,S] M-RoPE positions)
        if x.dim() >= 2 and x.shape[0] == 3 and x.shape[1] % m == 0:
            return x.reshape(3, m, x.shape[1] // m,
                             *x.shape[2:]).movedim(1, 0)
        if x.shape[0] % m:
            raise ValueError(f"batch of {x.shape[0]} does not split into "
                             f"{m} microbatches")
        return x.reshape(m, x.shape[0] // m, *x.shape[1:])
    return map_tensors(batch, resh)


def _value_and_grad(loss_fn, params, batch):
    """(loss, metrics, grads): grads of the loss wrt every leaf of
    ``params``, zeros where a leaf does not reach the loss."""
    leaves = map_tensors(params, lambda p: p.detach().requires_grad_())
    loss, metrics = loss_fn(leaves, batch)
    flat = []
    map_tensors(leaves, flat.append)
    grads = iter(torch.autograd.grad(loss, flat, allow_unused=True))

    def next_grad(p):
        g = next(grads)
        return torch.zeros_like(p) if g is None else g
    return (loss.detach(), map_tensors(metrics, torch.Tensor.detach),
            map_tensors(leaves, next_grad))


def make_train_step(model: Model, opt_cfg: OptConfig, compress=None):
    """``compress``: optional gradient compressor (``optim.compression``)."""
    loss_fn = make_loss_fn(model)
    m = model.run.microbatches

    def train_step(state, batch):
        params = state["params"]
        if m <= 1:
            loss, metrics, grads = _value_and_grad(loss_fn, params, batch)
        else:
            mb = _split_microbatches(batch, m)
            grads, loss, mets = None, None, []
            for i in range(m):
                l, met, g = _value_and_grad(
                    loss_fn, params, map_tensors(mb, lambda x: x[i]))
                if grads is None:       # the sums start from the first
                    grads, loss = map_tensors(g, lambda b: b.float()), l
                else:
                    grads = map_tensors(grads, lambda a, b: a + b.float(), g)
                    loss = loss + l
                mets.append(met)
            grads = map_tensors(grads, lambda g: g / m)
            loss = loss / m
            metrics = {k: torch.stack([x[k] for x in mets]).mean(0)
                       for k in mets[0]}

        if compress is not None:
            grads, state, cmetrics = compress.apply(grads, state)
            metrics.update(cmetrics)

        new_params, new_opt, opt_metrics = adamw_update(
            grads, state["opt"], params, opt_cfg)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        new_state = dict(state)
        new_state["params"] = new_params
        new_state["opt"] = new_opt
        return new_state, metrics

    return train_step


def init_train_state(model: Model, generator: torch.Generator,
                     compress=None, device=None) -> Dict[str, Any]:
    """Parameters drawn from ``generator`` on ``device`` (``"cuda"``
    unless named), zero moments and step."""
    params = model.init(generator, device)
    state = {"params": params, "opt": init_opt_state(params)}
    if compress is not None:
        state["ef_error"] = compress.init_error(params)
    return state

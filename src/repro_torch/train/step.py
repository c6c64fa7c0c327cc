"""Train step factory: forward + chunked CE + AdamW, with microbatched
gradient accumulation and mesh-aware sharding entered at each call (the
JAX package's ``train/step.py``).

The step is a function ``(state, batch) -> (state, metrics)``.  Parameters
and moments are updated in place (``optim.adamw.adamw_update``) and the
returned state dict holds the same tensors; a checkpoint snapshot copies
them.  ``train_state_specs`` gives the state's PartitionSpecs (parameters
TP, moments ZeRO-1) and ``abstract_train_state`` the state with no data,
the dry-run's input.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models.model_zoo import Model
from repro_torch.models.params import cast_tree, map_tensors
from repro_torch.optim.adamw import (OptConfig, adamw_update, init_opt_state,
                                     zero1_specs)
from repro_torch.parallel.sharding import (TRAIN_RULES, P, Rules,
                                           abstract_tensor, batch_laid,
                                           is_dtensor, use_sharding)
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
    """[m, B/m, ...] leaves: microbatch i holds rows i·B/m .. (i+1)·B/m - 1,
    as in the JAX package.  A batch-sharded DTensor is split within each
    device's rows instead (microbatch i holds rows i, m + i, 2m + i, ..),
    so that no row moves: the sums over microbatches are the same."""
    def resh(x):
        # batch dim may be axis 0 ([B,...]) or axis 1 ([3,B,S] M-RoPE positions)
        b = 1 if x.dim() >= 2 and x.shape[0] == 3 and x.shape[1] % m == 0 \
            else 0
        B = x.shape[b]
        if B % m:
            raise ValueError(f"batch of {B} does not split into "
                             f"{m} microbatches")
        rest = x.shape[b + 1:]
        lead = x.shape[:b]
        if is_dtensor(x):
            return x.reshape(*lead, B // m, m, *rest).movedim(b + 1, 0)
        return x.reshape(*lead, m, B // m, *rest).movedim(b, 0)
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


def make_train_step(model: Model, opt_cfg: OptConfig, mesh=None,
                    rules_table=TRAIN_RULES, compress=None):
    """``compress``: optional gradient compressor (``optim.compression``).
    With a ``mesh``, each call runs under ``use_sharding(mesh,
    rules_table)`` on a state and batch of DTensors."""
    loss_fn = make_loss_fn(model)
    m = model.run.microbatches

    def train_step(state, batch):
        with use_sharding(mesh, rules_table):
            return _train_step(state, batch_laid(batch))

    def _train_step(state, batch):
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


def train_state_specs(model: Model, mesh, rules: Rules, compress=None):
    """PartitionSpec tree for the train state (params TP, opt ZeRO-1)."""
    pspecs = model.param_specs(rules)
    abstract = model.abstract()
    if model.run.zero1:
        ospecs = zero1_specs(pspecs, abstract, mesh, rules)
    else:
        ospecs = pspecs
    state = {"params": pspecs,
             "opt": {"mu": ospecs, "nu": ospecs, "step": P()}}
    if compress is not None:
        state["ef_error"] = ospecs
    return state


def abstract_train_state(model: Model, mesh=None, rules=None, compress=None):
    """The train state with no data, the dry-run's input: meta tensors, or
    on ``mesh`` DTensors with meta shards laid out by
    ``train_state_specs``."""
    abstract = model.abstract()
    if mesh is None:
        specs = {"params": map_tensors(abstract, lambda _: None),
                 "opt": {"mu": map_tensors(abstract, lambda _: None),
                         "nu": map_tensors(abstract, lambda _: None),
                         "step": None}}
        if compress is not None:
            specs["ef_error"] = map_tensors(abstract, lambda _: None)
    else:
        specs = train_state_specs(model, mesh, rules, compress)

    def mk(aval, spec, dtype=None):
        return abstract_tensor(aval.shape, dtype or aval.dtype, mesh, spec)

    def f32(aval, spec):
        return mk(aval, spec, torch.float32)

    params = map_tensors(abstract, mk, specs["params"])
    mu = map_tensors(abstract, f32, specs["opt"]["mu"])
    nu = map_tensors(abstract, f32, specs["opt"]["nu"])
    step = abstract_tensor((), torch.int32, mesh, specs["opt"]["step"])
    state = {"params": params, "opt": {"mu": mu, "nu": nu, "step": step}}
    if compress is not None:
        state["ef_error"] = map_tensors(abstract, f32, specs["ef_error"])
    return state

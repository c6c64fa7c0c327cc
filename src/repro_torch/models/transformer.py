"""Decoder-only transformer LM (llama4 / moonshot / qwen2 / gemma2 / qwen2-vl)
and the layer loop the Mamba-2 and Hymba stacks share.

Parameters are stacked with a leading layer dim, as in the JAX package; its
``lax.scan`` over layers becomes a Python loop over layer indices, each
indexing views (never copies) of the stacked tensors.  The per-layer
locality flag comes from ``layer_plan`` as a Python bool, so gemma2's and
Hymba's local layers get a static window.  KV caches are stacked with a
leading layer dim too, ``{"attn": {"k", "v": [L,B,T,Hk,hd], "pos":
[L,B]}}``, and each layer's new entries are written into them in place.
The activation remat policy (``RunConfig.remat``) wraps each layer in
``torch.utils.checkpoint``, as the JAX package wraps its scan body in
``jax.checkpoint``.  Each trip of a scan is marked for the static
profiler (``core.op_analysis.open_trip``/``close_trip``), which samples
a step by layer as the JAX package's walker samples by scan trip.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.run import RunConfig
from repro_torch.core.op_analysis import close_trip, open_trip
from repro_torch.device import DeviceLike, resolve
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import (AttnRun, attention, def_attention,
                                       def_mlp, def_rmsnorm, mlp, rmsnorm)
from repro_torch.models.params import PDef, map_tensors, stack_pdefs
from repro_torch.parallel.sharding import (fsdp_gathered, seq_product, shard,
                                           unsharded)


# ---------------------------------------------------------------------------
# Layer patterns
# ---------------------------------------------------------------------------

def layer_flags(cfg: ModelConfig) -> np.ndarray:
    """is_local flag per layer."""
    L = cfg.num_layers
    pat = cfg.attn.layer_pattern
    if pat == "global" or cfg.attn.sliding_window is None:
        return np.zeros(L, bool)
    if pat == "local_global":               # gemma2: even layers local
        return np.array([i % 2 == 0 for i in range(L)])
    if pat == "hymba":                      # full attn at first/middle/last
        glob = {0, L // 2, L - 1}
        return np.array([i not in glob for i in range(L)])
    raise ValueError(pat)


def uses_uniform_global(cfg: ModelConfig) -> bool:
    return not layer_flags(cfg).any()


# ---------------------------------------------------------------------------
# Parameter tree
# ---------------------------------------------------------------------------

def def_block(cfg: ModelConfig) -> Dict[str, Any]:
    d = cfg.d_model
    p: Dict[str, Any] = {"ln_attn": def_rmsnorm(d), "ln_mlp": def_rmsnorm(d)}
    p["attn"] = def_attention(cfg)
    if cfg.sandwich_norms:
        p["ln_attn_post"] = def_rmsnorm(d)
        p["ln_mlp_post"] = def_rmsnorm(d)
    if cfg.moe is not None:
        p["moe"] = moe_lib.def_moe(cfg)
    else:
        p["mlp"] = def_mlp(d, cfg.d_ff)
    return p


def def_lm(cfg: ModelConfig) -> Dict[str, Any]:
    p: Dict[str, Any] = {
        "embed": PDef((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                      init="normal"),
        "layers": stack_pdefs(def_block(cfg), cfg.num_layers),
        "ln_final": def_rmsnorm(cfg.d_model),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = PDef((cfg.d_model, cfg.vocab_size), ("embed", "vocab"),
                            init="scaled")
    return p


# ---------------------------------------------------------------------------
# Cache
# ---------------------------------------------------------------------------

def init_attn_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                    device: DeviceLike = None):
    """One layer's cache {k, v: [B,T,Hk,hd], pos: [B]} on ``device``
    (``"cuda"`` unless named)."""
    dev = resolve(device)
    hk, hd = cfg.num_kv_heads, cfg.head_dim
    return {
        "k": shard(torch.zeros((batch, max_len, hk, hd), dtype=dtype,
                               device=dev),
                   "batch", "cache_seq", None, "head_dim"),
        "v": shard(torch.zeros((batch, max_len, hk, hd), dtype=dtype,
                               device=dev),
                   "batch", "cache_seq", None, "head_dim"),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=dev),
    }


def _stack_layers(per_layer, L: int):
    """Each leaf repeated along a new leading layer dim, as a copy: the
    layers write their caches in place, so they must not share memory."""
    return map_tensors(
        per_layer, lambda x: x[None].expand((L,) + tuple(x.shape)).clone())


def init_cache(cfg: ModelConfig, run: RunConfig, batch: int, max_len: int,
               device: DeviceLike = None):
    """Stacked (leading layer dim) cache: {"attn": {k, v, pos}} on
    ``device`` (``"cuda"`` unless named)."""
    per_layer = init_attn_cache(cfg, batch, max_len, run.kvdtype, device)
    return {"attn": _stack_layers(per_layer, cfg.num_layers)}


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _attn_run(run: RunConfig) -> AttnRun:
    return AttnRun(impl=run.attn_impl, block_q=run.block_q,
                   block_kv=run.block_kv,
                   blocked_threshold=run.blocked_threshold)


def block_apply(pl, x, *, cfg: ModelConfig, run: RunConfig, positions,
                local_flag, cache_layer=None, decode=False):
    seq_ax = "seq_shard" if not decode else "seq"
    h = rmsnorm(pl["ln_attn"], x, cfg.norm_eps)
    # pin the norm output to the seq-sharded layout, so the Megatron-SP
    # all-gather happens on the compute-dtype h at the qkv product
    h = shard(h, "batch", seq_ax, "embed")
    attn_out, new_cache = attention(
        pl["attn"], h, cfg=cfg, positions=positions, is_local=local_flag,
        run=_attn_run(run), cache=cache_layer, decode=decode)
    if cfg.sandwich_norms:
        attn_out = rmsnorm(pl["ln_attn_post"], attn_out, cfg.norm_eps)
    x = x + attn_out
    x = shard(x, "batch", seq_ax, "embed")

    h = rmsnorm(pl["ln_mlp"], x, cfg.norm_eps)
    h = shard(h, "batch", seq_ax, "embed")
    if cfg.moe is not None:
        mlp_out, aux = moe_lib.moe_block(pl["moe"], h, cfg=cfg)
    else:
        mlp_out, aux = mlp(pl["mlp"], h), {}
    if cfg.sandwich_norms:
        mlp_out = rmsnorm(pl["ln_mlp_post"], mlp_out, cfg.norm_eps)
    x = x + mlp_out
    x = shard(x, "batch", seq_ax, "embed")
    return x, new_cache, aux


def _dots_policy(ctx, op, *args, **kwargs):
    """Save the outputs of matrix products with no batch dimension (the
    JAX package's ``dots_with_no_batch_dims_saveable``); recompute the
    rest."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_wrap(fn, run: RunConfig):
    """``fn`` under the run's remat policy.  Only while autograd records:
    a forward with no backward (serving) has nothing to recompute."""
    if run.remat == "none" or not torch.is_grad_enabled():
        return fn
    if run.remat == "dots":
        ctx = functools.partial(create_selective_checkpoint_contexts,
                                _dots_policy)
        return functools.partial(checkpoint, fn, use_reentrant=False,
                                 context_fn=ctx)
    return functools.partial(checkpoint, fn, use_reentrant=False)


def embed_tokens(params, batch, cfg: ModelConfig, run: RunConfig):
    if "embeds" in batch:                # vlm / audio frontend stubs
        x = batch["embeds"].to(run.cdtype)
    else:
        # F.embedding, not indexing: its backward sums repeated tokens in a
        # fixed order (indexing's scatter-add does not on several threads)
        tokens = batch["tokens"]
        x = F.embedding(tokens.long(),
                        fsdp_gathered(params["embed"], tokens)).to(run.cdtype)
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=run.cdtype,
                             device=x.device)
    return x


def layer_plan(cfg: ModelConfig):
    """Static execution plan over the stacked layers, as in the JAX package.

    Heterogeneous patterns are split into *uniform* groups, so the locality
    flag is a constant inside each group.  Groups:

      ("scan",  start, count, flag)   — a contiguous run of layers
      ("single", idx, flag)           — one layer
      ("pair_scan", count)            — alternating local/global (gemma2):
                                        (even, odd) layer pairs
    """
    flags = layer_flags(cfg)
    L = cfg.num_layers
    if not flags.any():
        return [("scan", 0, L, False)]
    if cfg.attn.layer_pattern == "local_global" and L % 2 == 0:
        return [("pair_scan", L // 2)]
    plan = []
    i = 0
    while i < L:
        j = i
        while j < L and flags[j] == flags[i]:
            j += 1
        if j - i == 1:
            plan.append(("single", i, bool(flags[i])))
        else:
            plan.append(("scan", i, j - i, bool(flags[i])))
        i = j
    return plan


def _plan_trips(cfg: ModelConfig):
    """(looped, [(layer index, static is_local flag), ...]) per trip of the
    JAX package's scans, in execution order: a "scan" group's trip is one
    layer, a "pair_scan" group's an (even, odd) pair, a "single" group one
    trip outside any loop.  ``looped`` is whether the trip belongs to a
    scan of two trips or more: XLA inlines a loop that runs once, so the
    static profiler's samples (``core.op_analysis``) follow only those."""
    for group in layer_plan(cfg):
        if group[0] == "single":
            _, li, flag = group
            yield False, [(li, flag)]
        elif group[0] == "pair_scan":
            for i in range(group[1]):
                yield group[1] > 1, [(2 * i, True), (2 * i + 1, False)]
        else:
            _, start, count, flag = group
            for li in range(start, start + count):
                yield count > 1, [(li, flag)]


def forward_stack(params, batch, *, cfg: ModelConfig, run: RunConfig,
                  block_fn, cache=None, decode=False):
    """Generic layer loop for the decoder-only families (dense, moe, vlm,
    ssm, hybrid).

    ``block_fn(pl, x, positions, local_flag, cache_layer, decode)``
        -> (x, new_cache_layer, aux)

    ``pl`` and ``cache_layer`` are views of layer ``li`` of the stacked
    parameters and cache.  A layer's new cache entries are copied into the
    stacked cache (a no-op for the entries it already wrote in place), so
    the returned cache is the given one, updated.
    """
    x = embed_tokens(params, batch, cfg, run)
    B, S, D = x.shape
    positions = batch.get("positions")
    if positions is None:
        if decode and cache is not None and "attn" in cache:
            # a copy: the layers advance the cached positions in place
            positions = cache["attn"]["pos"][0][:, None].clone()  # [B,1]
        elif decode:                        # ssm: unused
            positions = torch.zeros((B, 1), dtype=torch.int32,
                                    device=x.device)
        else:
            positions = torch.arange(S, device=x.device)[None].expand(B, S)
    x = shard(x, "batch", "seq_shard" if not decode else "seq", "embed")

    # one unbind a stacked leaf: its backward stacks the layers' gradients
    # once, where indexing a layer at a time would add L stacked-size
    # gradients (work quadratic in the depth).  A leaf sharded along its
    # layers is gathered along them first
    per_layer = map_tensors(params["layers"],
                            lambda p: unsharded(p, (0,)).unbind(0))
    aux_acc: Dict[str, Any] = {}
    for looped, trip in _plan_trips(cfg):
        if looped:
            x = open_trip(x, "layers")
        for li, flag in trip:
            pl = map_tensors(per_layer, lambda ps: ps[li])
            cl = None if cache is None else map_tensors(cache,
                                                        lambda c: c[li])
            # the flag is bound as a default: a remat recompute calls the
            # body after the loop has moved on
            x, nc, aux = _remat_wrap(
                lambda c, p_, cl_, f=flag: block_fn(
                    fsdp_gathered(p_, c), c, positions=positions,
                    local_flag=f,
                    cache_layer=cl_, decode=decode), run)(x, pl, cl)
            if nc is not None:
                _cache_set(cl, nc)
            for k, v in aux.items():
                aux_acc[k] = aux_acc.get(k, 0.0) + v.sum()
        if looped:
            x = close_trip(x, "layers")

    x = rmsnorm(params["ln_final"], x, cfg.norm_eps)
    return x, cache, aux_acc


def _cache_set(view, new):
    """Copy a layer's new cache entries into its views of the stacked
    cache, skipping entries that already are those views (the same
    storage at the same offset: meta tensors have no addresses)."""
    if isinstance(view, dict):
        for k in view:
            _cache_set(view[k], new[k])
    elif (new.untyped_storage()._cdata != view.untyped_storage()._cdata
          or new.storage_offset() != view.storage_offset()):
        view.copy_(new)


def make_dense_block(cfg: ModelConfig, run: RunConfig):
    def block(pl, x, *, positions, local_flag, cache_layer, decode):
        cl = cache_layer["attn"] if cache_layer is not None else None
        y, nc, aux = block_apply(pl, x, cfg=cfg, run=run, positions=positions,
                                 local_flag=local_flag, cache_layer=cl,
                                 decode=decode)
        return y, ({"attn": nc} if nc is not None else None), aux
    return block


def forward_lm(params, batch, *, cfg: ModelConfig, run: RunConfig,
               cache=None, decode=False):
    """Dense/MoE/VLM decoder-only forward: (hidden, new_cache, aux)."""
    return forward_stack(params, batch, cfg=cfg, run=run,
                         block_fn=make_dense_block(cfg, run),
                         cache=cache, decode=decode)


def lm_logits(params, hidden, cfg: ModelConfig, run: RunConfig):
    """[.., D] -> [.., V] with optional final softcap (gemma2)."""
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    w = fsdp_gathered(w, hidden)
    logits = seq_product(hidden, w.to(hidden.dtype))
    if cfg.attn.final_softcap is not None:
        c = cfg.attn.final_softcap
        logits = c * torch.tanh(logits.float() / c)
    return logits

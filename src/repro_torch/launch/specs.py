"""Stand-ins with no data for every model input (the JAX package's
``launch/specs.py``).

``input_specs(cfg, shape, mesh, run)`` returns the abstract inputs of the
(arch × shape) cell — a training batch, a prefill request batch, or a
decode step (tokens + KV/SSM cache) — with no allocation: meta tensors, or
on a mesh DTensors whose local shards are meta tensors of the shard's
shape, laid out by the cell's rule table (``rules_table_for``: train /
fsdp / prefill / decode / long-decode context-parallel).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.configs.run import RunConfig
from repro_torch.models.model_zoo import Model, build_model
from repro_torch.parallel.sharding import (DECODE_RULES, FSDP_RULES,
                                           LONG_DECODE_RULES, PREFILL_RULES,
                                           TRAIN_RULES, Rules,
                                           abstract_tensor, make_rules,
                                           use_sharding)


def rules_table_for(shape: ShapeConfig, run: Optional[RunConfig] = None) -> Dict:
    if shape.kind == "train":
        if run is not None and run.sharding_mode == "fsdp":
            return FSDP_RULES
        return TRAIN_RULES
    if shape.kind == "prefill":
        return PREFILL_RULES
    if shape.name == "long_500k":
        return LONG_DECODE_RULES
    return DECODE_RULES


def _sds(shape, dtype, mesh, rules: Optional[Rules], *axes):
    spec = None if mesh is None else rules.pspec_checked(tuple(shape), axes)
    return abstract_tensor(tuple(shape), dtype, mesh, spec)


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, mesh, rules,
                run: RunConfig) -> Dict[str, Any]:
    """Abstract train/prefill batch for this cell."""
    B, S = shape.global_batch, shape.seq_len
    i32, cdt = torch.int32, run.cdtype
    out: Dict[str, Any] = {}
    if cfg.family == "encdec":
        out["src_embeds"] = _sds((B, S // 2, cfg.d_model), cdt, mesh, rules,
                                 "batch", "seq", None)
        out["tgt_tokens"] = _sds((B, S // 2), i32, mesh, rules, "batch", "seq")
        if shape.kind == "train":
            out["targets"] = _sds((B, S // 2), i32, mesh, rules, "batch", "seq")
        return out
    if cfg.frontend == "vision_patches":
        out["embeds"] = _sds((B, S, cfg.d_model), cdt, mesh, rules,
                             "batch", "seq", None)
        out["positions"] = _sds((3, B, S), i32, mesh, rules,
                                None, "batch", "seq")
    elif cfg.frontend == "audio_frames":
        out["embeds"] = _sds((B, S, cfg.d_model), cdt, mesh, rules,
                             "batch", "seq", None)
    else:
        out["tokens"] = _sds((B, S), i32, mesh, rules, "batch", "seq")
    if shape.kind == "train":
        out["targets"] = _sds((B, S), i32, mesh, rules, "batch", "seq")
    return out


# ---------------------------------------------------------------------------
# Cache specs (decode cells): the init's shapes on meta, then the layouts
# ---------------------------------------------------------------------------

_CACHE_AXES = {
    # leaf key -> logical axes per rank (stacked leading layer dim)
    "k": {5: (None, "batch", "cache_seq", None, "head_dim")},
    "v": {5: (None, "batch", "cache_seq", None, "head_dim")},
    "pos": {2: (None, "batch")},
    "conv": {4: (None, "batch", None, "act_ssm_inner")},
    "ssm": {5: (None, "batch", "act_ssm_heads", None, None)},
    "cross_k": {5: (None, "batch", "cache_seq", None, "head_dim")},
    "cross_v": {5: (None, "batch", "cache_seq", None, "head_dim")},
}


def _map_with_key(tree, fn, key=None):
    """``fn(key, leaf)`` for each leaf, ``key`` the nearest dict key."""
    if isinstance(tree, dict):
        return {k: _map_with_key(v, fn, k) for k, v in tree.items()}
    return fn(key, tree)


def cache_specs(model: Model, batch: int, max_len: int, mesh, rules,
                src_len: Optional[int] = None):
    with use_sharding(None, {}):            # the shapes, laid out below
        if model.cfg.family == "encdec":
            shapes = model.init_cache(batch, max_len, src_len=src_len,
                                      device="meta")
        else:
            shapes = model.init_cache(batch, max_len, device="meta")

    def attach(key, aval):
        axes_by_rank = _CACHE_AXES.get(key, {})
        axes = axes_by_rank.get(aval.dim(), tuple([None] * aval.dim()))
        return _sds(aval.shape, aval.dtype, mesh, rules, *axes)

    return _map_with_key(shapes, attach)


def decode_token_specs(cfg: ModelConfig, batch: int, mesh, rules):
    return _sds((batch, 1), torch.int32, mesh, rules, "batch", "seq")


def input_specs(cfg: ModelConfig, shape: ShapeConfig, mesh, run: RunConfig):
    """Full abstract inputs for the cell's step function.

    train  -> (batch,)  (the state: ``train.step.abstract_train_state``)
    prefill-> (batch,)
    decode -> (tokens, cache)
    """
    rules = make_rules(mesh, rules_table_for(shape, run))
    if shape.kind in ("train", "prefill"):
        return (batch_specs(cfg, shape, mesh, rules, run),)
    # decode: cache sized to seq_len, batch of single tokens
    model = build_model(cfg, run)
    B, S = shape.global_batch, shape.seq_len
    src_len = S // 2 if cfg.family == "encdec" else None
    max_len = S // 2 if cfg.family == "encdec" else S
    cache = cache_specs(model, B, max_len, mesh, rules, src_len=src_len)
    toks = decode_token_specs(cfg, B, mesh, rules)
    return (toks, cache)

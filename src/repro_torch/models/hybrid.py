"""Attention-free (Mamba-2 LM) and hybrid (Hymba) blocks.

Hymba (arXiv:2411.13676): each layer runs attention heads and mamba heads in
*parallel* on the same normed input; the two outputs are RMS-normalized and
averaged with learned per-channel scales, then a SwiGLU MLP follows.  Three
layers (first / middle / last) use full global attention, the rest a sliding
window: the flag arrives as a Python bool from ``transformer._plan_trips``,
so ``attn_impl="cuda"`` gets a static window.  Meta-tokens from the paper
are out of scope, as in the JAX package.
"""
from __future__ import annotations

from typing import Any, Dict

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.run import RunConfig
from repro_torch.device import DeviceLike
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (attention, def_attention, def_mlp,
                                       def_rmsnorm, mlp, rmsnorm)
from repro_torch.models.params import PDef, stack_pdefs
from repro_torch.models.transformer import (_attn_run, _stack_layers,
                                            init_attn_cache)
from repro_torch.parallel.sharding import match_placements, shard


# ---------------------------------------------------------------------------
# Mamba2 LM (attention-free)
# ---------------------------------------------------------------------------

def def_ssm_block(cfg: ModelConfig) -> Dict[str, Any]:
    return {"ln": def_rmsnorm(cfg.d_model), "mamba": ssm_lib.def_mamba2(cfg)}


def _def_lm(cfg: ModelConfig, block: Dict[str, Any]) -> Dict[str, Any]:
    p = {
        "embed": PDef((cfg.vocab_size, cfg.d_model), ("vocab", "embed")),
        "layers": stack_pdefs(block, cfg.num_layers),
        "ln_final": def_rmsnorm(cfg.d_model),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = PDef((cfg.d_model, cfg.vocab_size), ("embed", "vocab"),
                            init="scaled")
    return p


def def_ssm_lm(cfg: ModelConfig) -> Dict[str, Any]:
    return _def_lm(cfg, def_ssm_block(cfg))


def make_ssm_block(cfg: ModelConfig, run: RunConfig):
    def block(pl, x, *, positions, local_flag, cache_layer, decode):
        del positions, local_flag
        h = rmsnorm(pl["ln"], x, cfg.norm_eps)
        cl = cache_layer["ssm"] if cache_layer is not None else None
        out, nc = ssm_lib.mamba2_block(pl["mamba"], h, cfg=cfg, cache=cl,
                                       decode=decode)
        x = x + out
        x = shard(x, "batch", "seq_shard" if not decode else "seq", "embed")
        return x, ({"ssm": nc} if nc is not None else None), {}
    return block


def init_ssm_cache(cfg: ModelConfig, run: RunConfig, batch: int,
                   device: DeviceLike = None):
    """Stacked cache {"ssm": {conv, ssm}} on ``device`` (``"cuda"`` unless
    named)."""
    per_layer = {"ssm": ssm_lib.init_mamba_cache(cfg, batch, run.cdtype,
                                                 device)}
    return _stack_layers(per_layer, cfg.num_layers)


# ---------------------------------------------------------------------------
# Hymba hybrid block
# ---------------------------------------------------------------------------

def def_hybrid_block(cfg: ModelConfig) -> Dict[str, Any]:
    d = cfg.d_model
    return {
        "ln_in": def_rmsnorm(d),
        "attn": def_attention(cfg),
        "mamba": ssm_lib.def_mamba2(cfg),
        "norm_attn_out": def_rmsnorm(d),
        "norm_ssm_out": def_rmsnorm(d),
        "ln_mlp": def_rmsnorm(d),
        "mlp": def_mlp(d, cfg.d_ff),
    }


def def_hybrid_lm(cfg: ModelConfig) -> Dict[str, Any]:
    return _def_lm(cfg, def_hybrid_block(cfg))


def make_hybrid_block(cfg: ModelConfig, run: RunConfig):
    def block(pl, x, *, positions, local_flag, cache_layer, decode):
        h = rmsnorm(pl["ln_in"], x, cfg.norm_eps)
        acl = cache_layer["attn"] if cache_layer is not None else None
        scl = cache_layer["ssm"] if cache_layer is not None else None
        attn_out, a_nc = attention(pl["attn"], h, cfg=cfg, positions=positions,
                                   is_local=local_flag, run=_attn_run(run),
                                   cache=acl, decode=decode)
        ssm_out, s_nc = ssm_lib.mamba2_block(pl["mamba"], h, cfg=cfg,
                                             cache=scl, decode=decode)
        # each branch laid out as the residual stream before its norm (no
        # counterpart in the reference, whose GSPMD lays the sum out): the
        # two come in crossed layouts (at long_500k attention's partial
        # over 'data' and split over 'model', the SSM's the other way
        # round), and torch 2.11's propagation picks for the norms and the
        # sum a Shard -> Partial that it cannot make
        attn_out = match_placements(attn_out, x)
        ssm_out = match_placements(ssm_out, x)
        fused = 0.5 * (rmsnorm(pl["norm_attn_out"], attn_out, cfg.norm_eps) +
                       rmsnorm(pl["norm_ssm_out"], ssm_out, cfg.norm_eps))
        x = x + fused
        x = shard(x, "batch", "seq_shard" if not decode else "seq", "embed")
        h2 = rmsnorm(pl["ln_mlp"], x, cfg.norm_eps)
        x = x + mlp(pl["mlp"], h2)
        x = shard(x, "batch", "seq_shard" if not decode else "seq", "embed")
        nc = None
        if a_nc is not None or s_nc is not None:
            nc = {"attn": a_nc, "ssm": s_nc}
        return x, nc, {}
    return block


def init_hybrid_cache(cfg: ModelConfig, run: RunConfig, batch: int,
                      max_len: int, device: DeviceLike = None):
    """Stacked cache {"attn": {k, v, pos}, "ssm": {conv, ssm}} on ``device``
    (``"cuda"`` unless named)."""
    per_layer = {
        "attn": init_attn_cache(cfg, batch, max_len, run.kvdtype, device),
        "ssm": ssm_lib.init_mamba_cache(cfg, batch, run.cdtype, device),
    }
    return _stack_layers(per_layer, cfg.num_layers)

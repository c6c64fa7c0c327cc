"""Encoder-decoder backbone (SeamlessM4T-medium).

The audio frontend is a stub, as in the JAX package: the encoder takes
precomputed frame embeddings [B, S_src, D].  The JAX package's ``lax.scan``
over each stack becomes a Python loop over layer indices, each indexing
views of the stacked parameters and caches.

Decode carries two caches per decoder layer: the causal self-attention cache
and the (write-once at prefill) cross-attention K/V over the encoder output.
The encoder's self-attention is unmasked (``causal=False``), so under
``attn_impl="cuda"`` it is a non-causal launch of the flash kernel.  The
cross-attention routes as the JAX package's does and never reaches flash:
``attend_decode`` for one query, ``attend_blocked`` above
``blocked_threshold`` queries, ``attend_full`` otherwise.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.run import RunConfig
from repro_torch.core.op_analysis import close_trip, open_trip
from repro_torch.device import DeviceLike, resolve
from repro_torch.models.layers import (_project, attend_blocked,
                                       attend_decode, attend_full, attention,
                                       def_attention, def_mlp, def_rmsnorm,
                                       mlp, rmsnorm)
from repro_torch.models.params import PDef, map_tensors, stack_pdefs
from repro_torch.models.transformer import (_attn_run, _cache_set,
                                            _remat_wrap, _stack_layers,
                                            init_attn_cache)
from repro_torch.parallel.sharding import shard


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def def_encoder_block(cfg: ModelConfig) -> Dict[str, Any]:
    d = cfg.d_model
    return {"ln_attn": def_rmsnorm(d), "attn": def_attention(cfg),
            "ln_mlp": def_rmsnorm(d), "mlp": def_mlp(d, cfg.d_ff)}


def def_decoder_block(cfg: ModelConfig) -> Dict[str, Any]:
    d = cfg.d_model
    return {"ln_self": def_rmsnorm(d), "self_attn": def_attention(cfg),
            "ln_cross": def_rmsnorm(d), "cross_attn": def_attention(cfg),
            "ln_mlp": def_rmsnorm(d), "mlp": def_mlp(d, cfg.d_ff)}


def def_encdec(cfg: ModelConfig) -> Dict[str, Any]:
    return {
        "embed": PDef((cfg.vocab_size, cfg.d_model), ("vocab", "embed")),
        "enc_layers": stack_pdefs(def_encoder_block(cfg),
                                  cfg.num_encoder_layers),
        "enc_ln_final": def_rmsnorm(cfg.d_model),
        "dec_layers": stack_pdefs(def_decoder_block(cfg), cfg.num_layers),
        "ln_final": def_rmsnorm(cfg.d_model),
        "lm_head": PDef((cfg.d_model, cfg.vocab_size), ("embed", "vocab"),
                        init="scaled"),
    }


# ---------------------------------------------------------------------------
# Cross attention
# ---------------------------------------------------------------------------

def _proj_kv(p, enc_out, cfg):
    return _project(enc_out, p["wk"]), _project(enc_out, p["wv"])


def cross_attention(p, x, *, cfg: ModelConfig, run: RunConfig,
                    enc_out=None, kv=None):
    """q from x [B,St,D]; k/v from enc_out or precomputed ``kv`` (decode)."""
    B, S, D = x.shape
    hq, hk, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    G = hq // hk
    q = _project(x, p["wq"])
    if kv is None:
        k, v = _proj_kv(p, enc_out, cfg)
    else:
        k, v = kv
    qg = q.reshape(B, S, hk, G, hd)
    if S == 1:
        # decode: full (non-causal) attention over the whole cross cache
        pos = torch.full((B,), k.shape[1] - 1, dtype=torch.int32,
                         device=x.device)
        out = attend_decode(qg, k, v, cur_pos=pos, window=None, softcap=None)
    elif S > run.blocked_threshold:
        out = attend_blocked(qg, k, v, causal=False, window=None,
                             softcap=None, block_q=run.block_q,
                             block_kv=run.block_kv)
    else:
        out = attend_full(qg, k, v, q_pos=torch.arange(S, device=x.device),
                          k_pos=torch.arange(k.shape[1], device=x.device),
                          causal=False, window=None, softcap=None)
    out = out.reshape(B, S, hq * hd)
    return out @ p["wo"].to(x.dtype).reshape(hq * hd, D)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _embed_scale(x, cfg: ModelConfig, run: RunConfig):
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=run.cdtype,
                             device=x.device)
    return x


def encode(params, src_embeds, *, cfg: ModelConfig, run: RunConfig):
    x = _embed_scale(src_embeds.to(run.cdtype), cfg, run)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    x = shard(x, "batch", "seq_shard", "embed")

    def body(xx, pl):
        h = rmsnorm(pl["ln_attn"], xx, cfg.norm_eps)
        out, _ = attention(pl["attn"], h, cfg=cfg, positions=positions,
                           run=_attn_run(run), causal=False)
        xx = xx + out
        xx = shard(xx, "batch", "seq_shard", "embed")
        h = rmsnorm(pl["ln_mlp"], xx, cfg.norm_eps)
        xx = xx + mlp(pl["mlp"], h)
        return shard(xx, "batch", "seq_shard", "embed")

    layers = params["enc_layers"]
    looped = cfg.num_encoder_layers > 1     # XLA inlines a one-trip loop
    for li in range(cfg.num_encoder_layers):
        if looped:
            x = open_trip(x, "encoder")
        x = _remat_wrap(body, run)(x, map_tensors(layers, lambda p: p[li]))
        if looped:
            x = close_trip(x, "encoder")
    return rmsnorm(params["enc_ln_final"], x, cfg.norm_eps)


def forward_encdec(params, batch, *, cfg: ModelConfig, run: RunConfig,
                   cache=None, decode=False):
    """Returns (decoder hidden, cache|None, aux); a given cache is updated
    in place and returned.

    train/prefill: batch = {src_embeds [B,Ss,D], tgt_tokens [B,St]}
    decode:        batch = {tokens [B,1]}, cache from prefill
    """
    if decode:
        if cache is None:
            raise ValueError("decode steps one token against a cache")
        x = F.embedding(batch["tokens"].long(), params["embed"]).to(
            run.cdtype)
        x = _embed_scale(x, cfg, run)
        # a copy: the layers advance the cached positions in place
        positions = cache["self"]["pos"][0][:, None].clone()
        enc_out = None
    else:
        enc_out = encode(params, batch["src_embeds"], cfg=cfg, run=run)
        x = F.embedding(batch["tgt_tokens"].long(), params["embed"]).to(
            run.cdtype)
        x = _embed_scale(x, cfg, run)
        B, St, _ = x.shape
        positions = torch.arange(St, device=x.device)[None].expand(B, St)
        x = shard(x, "batch", "seq_shard", "embed")

    def body(xx, pl, self_cl, cross_kv):
        h = rmsnorm(pl["ln_self"], xx, cfg.norm_eps)
        out, self_nc = attention(pl["self_attn"], h, cfg=cfg,
                                 positions=positions, run=_attn_run(run),
                                 cache=self_cl, decode=decode)
        xx = xx + out
        h = rmsnorm(pl["ln_cross"], xx, cfg.norm_eps)
        if decode:
            cross_out = cross_attention(pl["cross_attn"], h, cfg=cfg, run=run,
                                        kv=cross_kv)
            new_kv = None                    # written once, at prefill
        else:
            cross_out = cross_attention(pl["cross_attn"], h, cfg=cfg, run=run,
                                        enc_out=enc_out)
            new_kv = _proj_kv(pl["cross_attn"], enc_out, cfg) \
                if self_cl is not None else None
        xx = xx + cross_out
        h = rmsnorm(pl["ln_mlp"], xx, cfg.norm_eps)
        xx = xx + mlp(pl["mlp"], h)
        if not decode:
            xx = shard(xx, "batch", "seq_shard", "embed")
        return xx, self_nc, new_kv

    layers = params["dec_layers"]
    looped = cfg.num_layers > 1
    for li in range(cfg.num_layers):
        if looped:
            x = open_trip(x, "decoder")
        pl = map_tensors(layers, lambda p: p[li])
        if cache is None:
            x, _, _ = _remat_wrap(
                lambda c, p_: body(c, p_, None, None), run)(x, pl)
        else:
            self_cl = map_tensors(cache["self"], lambda c: c[li])
            ck, cv = cache["cross_k"][li], cache["cross_v"][li]
            x, self_nc, new_kv = _remat_wrap(body, run)(x, pl, self_cl,
                                                        (ck, cv))
            _cache_set(self_cl, self_nc)
            if new_kv is not None:
                ck.copy_(new_kv[0])
                cv.copy_(new_kv[1])
        if looped:
            x = close_trip(x, "decoder")

    x = rmsnorm(params["ln_final"], x, cfg.norm_eps)
    return x, cache, {}


def init_encdec_cache(cfg: ModelConfig, run: RunConfig, batch: int,
                      tgt_len: int, src_len: int, device: DeviceLike = None):
    """{"self": {k, v, pos} stacked over the decoder layers, "cross_k",
    "cross_v": [L, B, src_len, Hk, hd]} on ``device`` (``"cuda"`` unless
    named)."""
    dev = resolve(device)
    hk, hd = cfg.num_kv_heads, cfg.head_dim
    self_cache = _stack_layers(
        init_attn_cache(cfg, batch, tgt_len, run.kvdtype, dev),
        cfg.num_layers)
    shape = (cfg.num_layers, batch, src_len, hk, hd)
    return {"self": self_cache,
            "cross_k": shard_5d(torch.zeros(shape, dtype=run.kvdtype,
                                            device=dev)),
            "cross_v": shard_5d(torch.zeros(shape, dtype=run.kvdtype,
                                            device=dev))}


def shard_5d(x):
    return shard(x, None, "batch", "cache_seq", None, "head_dim")

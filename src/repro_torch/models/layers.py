"""Shared transformer layers: norms, rotary embeddings, attention, MLP.

Attention has three implementations here (``RunConfig.attn_impl``):
  * ``full``    — dense softmax attention in PyTorch ops; O(S²) memory.
  * ``blocked`` — flash-style attention in PyTorch ops over (q, kv) block
                  pairs, with hand-written backward passes
                  (``BlockedFlash``, ``BandedAttention``); O(S·hd) saved
                  for the backward.  Plain PyTorch, as the JAX package's
                  is plain XLA: no Pallas kernel stands behind it.
  * ``cuda``    — the hand-written Hopper kernel
                  (``repro_torch.kernels.flash_attention``), the
                  counterpart of the JAX package's ``pallas``.
``auto`` keeps the JAX package's rule (``blocked`` above the threshold).

All softmax math is f32 regardless of activation dtype: logits come from
inputs upcast to f32, the counterpart of ``preferred_element_type=f32``
(a bf16 product of bf16 inputs is exact in f32, so the upcast gives the
same logits).  Products the JAX package leaves in the input dtype
(probabilities times values) stay in it here too.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.op_analysis import identical_trips
from repro_torch.models.params import PDef
from repro_torch.parallel.sharding import (is_dtensor, local_like,
                                           local_shard, match_placements,
                                           merge_ready, seq_product, shard,
                                           shard_local)

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def def_rmsnorm(d: int) -> Dict[str, PDef]:
    return {"scale": PDef((d,), ("embed",), init="zeros")}  # (1 + scale) form


def rmsnorm(p, x, eps: float = 1e-6):
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + p["scale"].float())).to(dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings (standard + M-RoPE)
# ---------------------------------------------------------------------------

def _rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    exp = torch.arange(0, head_dim // 2, dtype=torch.float32,
                       device=device) / (head_dim // 2)
    return 1.0 / (theta ** exp)                      # [hd/2]


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               mrope_sections: Optional[Tuple[int, int, int]] = None):
    """x: [B,S,H,hd]; positions: [B,S] or [3,B,S] for M-RoPE."""
    hd = x.shape[-1]
    freqs = _rope_freqs(hd, theta, x.device)         # [hd/2]
    if mrope_sections is None:
        angles = positions.float()[..., None] * freqs      # [B,S,hd/2]
    else:
        if positions.dim() != 3:
            raise ValueError("M-RoPE needs [3,B,S] positions (t,h,w)")
        a = positions.float()[..., None] * freqs          # [3,B,S,hd/2]
        if sum(mrope_sections) != hd // 2:
            raise ValueError(f"M-RoPE sections {mrope_sections} must sum "
                             f"to hd/2 = {hd // 2}")
        parts = []
        start = 0
        for i, s in enumerate(mrope_sections):
            parts.append(a[i, ..., start:start + s])
            start += s
        angles = torch.cat(parts, dim=-1)            # [B,S,hd/2]
    cos = torch.cos(angles)[:, :, None, :]           # [B,S,1,hd/2]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention core
# ---------------------------------------------------------------------------

def _softcap(logits, cap: Optional[float]):
    if cap is None:
        return logits
    return cap * torch.tanh(logits / cap)


def _bias(ok):
    """Additive f32 mask: 0 where ``ok``, ``NEG_INF`` elsewhere."""
    return torch.zeros_like(ok, dtype=torch.float32).masked_fill_(~ok,
                                                                 NEG_INF)


def _mask_bias(q_pos, k_pos, *, causal: bool, window: Optional[int],
               local_flag=None, kv_valid_len=None):
    """Additive f32 mask bias of shape broadcastable to [.., Sq, Sk].

    ``local_flag``: a bool (or 0-d bool tensor); when given, the window
    constraint only applies where the flag is True.
    """
    qp = q_pos[..., :, None]
    kp = k_pos[..., None, :]
    if causal:
        ok = kp <= qp
    else:
        ok = torch.ones(torch.broadcast_shapes(qp.shape, kp.shape),
                        dtype=torch.bool, device=qp.device)
    if window is not None:
        win_ok = qp - kp < window
        if local_flag is not None:
            win_ok = win_ok | ~torch.as_tensor(local_flag, device=qp.device)
        ok = ok & win_ok
    if kv_valid_len is not None:
        ok = ok & (kp < kv_valid_len)
    return _bias(ok)


def attend_full(q, k, v, *, q_pos, k_pos, causal, window, softcap,
                local_flag=None, kv_valid_len=None):
    """q:[B,Sq,Hk,G,hd] grouped query; k,v:[B,Sk,Hk,hd]."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float()) * scale
    logits = _softcap(logits, softcap)
    bias = _mask_bias(q_pos, k_pos, causal=causal, window=window,
                      local_flag=local_flag,
                      kv_valid_len=kv_valid_len)     # [Sq,Sk] or [B,Sq,Sk]
    if bias.dim() == 2:
        bias = bias[None, None, None]
    else:
        bias = bias[:, None, None]
    logits = logits + bias
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhgqk,bkhd->bqhgd", probs, v)


_HUGE_WINDOW = 1.0e9


def _win_arr(window, local_flag, device) -> torch.Tensor:
    """Fold (static window, per-layer bool flag) into one f32 scalar."""
    huge = torch.tensor(_HUGE_WINDOW, dtype=torch.float32, device=device)
    if window is None:
        return huge
    w = torch.tensor(float(window), dtype=torch.float32, device=device)
    if local_flag is None:
        return w
    return torch.where(torch.as_tensor(local_flag, device=device), w, huge)


def _block_bias(qp, kp, win_arr, causal: bool):
    """Additive f32 mask [bq, bkv] from position vectors and the window."""
    d = qp[:, None].float() - kp[None, :].float()
    ok = d < win_arr
    if causal:
        ok = ok & (d >= 0)
    return _bias(ok)


def _scores(qb, kb, scale):
    """f32 logits [B,Hk,G,bq,bkv] of q [B,bq,Hk,G,hd], k [B,bkv,Hk,hd]."""
    return torch.einsum("bqhgd,bkhd->bhgqk", qb.float(), kb.float()) * scale


def _capped(s_raw, softcap):
    """(softcapped logits, tanh term for the backward or None)."""
    if softcap is None:
        return s_raw, None
    t = torch.tanh(s_raw / softcap)
    return softcap * t, t


def _grads_of_block(qb, kb, vb, dob, Lb, db, bias, scale, softcap):
    """One (q, kv) block pair of the backward, all in f32: (dq block,
    dk and dv contributions of the pair)."""
    s, t = _capped(_scores(qb, kb, scale), softcap)
    p = torch.exp(s + bias - Lb[..., None])              # [B,Hk,G,bq,bkv]
    do32 = dob.float()
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, do32)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", do32, vb.float())
    ds = p * (dp - db[..., None])                        # wrt softcapped s
    if t is not None:
        ds = ds * (1.0 - t * t)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kb.float()) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qb.float()) * scale
    return dq, dk, dv


def _delta(do, out):
    return torch.einsum("bqhgd,bqhgd->bhgq", do.float(), out.float())


class BlockedFlash(torch.autograd.Function):
    """FlashAttention-2 in PyTorch ops with a hand-written backward (the
    JAX package's ``_flash_fn``).

    Forward: for each q block, an online softmax over the kv blocks; saves
    (q, k, v, out, L = m + log l), O(S·hd), never the per-block f32
    accumulators (autograd through the loop would keep ``acc`` at every
    inner step: O(nk·S·hd) f32 a layer).  Backward: recomputes p per (kv,
    q) block pair; dk/dv per kv block, dq accumulated in f32.  Every block
    pair runs the same ops on the same shapes: on meta tensors under the
    operator counter, two trips of each loop run and count for all
    (``op_analysis.identical_trips``).
    """

    @staticmethod
    def forward(ctx, q, k, v, win_arr, causal, softcap, block_q, block_kv):
        B, Sq, Hk, G, hd = q.shape
        Sk = k.shape[1]
        scale = hd ** -0.5
        qp = torch.arange(Sq, device=q.device)
        kp = torch.arange(Sk, device=q.device)
        out = torch.empty_like(q, dtype=v.dtype)
        L = torch.empty((B, Hk, G, Sq), dtype=torch.float32, device=q.device)
        with identical_trips(Sq // block_q, q) as nq:
            for q0 in range(0, nq * block_q, block_q):
                qs = slice(q0, q0 + block_q)
                qb = q[:, qs]
                m = torch.full((B, Hk, G, block_q), NEG_INF,
                               dtype=torch.float32, device=q.device)
                l = torch.zeros_like(m)
                acc = torch.zeros((B, Hk, G, block_q, hd),
                                  dtype=torch.float32, device=q.device)
                with identical_trips(Sk // block_kv, q) as nk:
                    for k0 in range(0, nk * block_kv, block_kv):
                        ks = slice(k0, k0 + block_kv)
                        s, _ = _capped(_scores(qb, k[:, ks], scale), softcap)
                        s = s + _block_bias(qp[qs], kp[ks], win_arr, causal)
                        m_new = torch.maximum(m, s.amax(dim=-1))
                        alpha = torch.exp(m - m_new)
                        p = torch.exp(s - m_new[..., None])
                        l = l * alpha + p.sum(dim=-1)
                        acc = acc * alpha[..., None] + torch.einsum(
                            "bhgqk,bkhd->bhgqd", p.to(v.dtype),
                            v[:, ks]).float()
                        m = m_new
                lc = torch.clamp(l, min=1e-30)
                out[:, qs] = (acc / lc[..., None]).permute(0, 3, 1, 2, 4)
                L[..., qs] = m + torch.log(lc)
        ctx.save_for_backward(q, k, v, out, L, win_arr)
        ctx.args = (causal, softcap, block_q, block_kv)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, L, win_arr = ctx.saved_tensors
        causal, softcap, block_q, block_kv = ctx.args
        Sq, hd = q.shape[1], q.shape[-1]
        Sk = k.shape[1]
        scale = hd ** -0.5
        qp = torch.arange(Sq, device=q.device)
        kp = torch.arange(Sk, device=q.device)
        delta = _delta(do, out)                              # [B,Hk,G,Sq]
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.empty(k.shape, dtype=torch.float32, device=q.device)
        dv = torch.empty_like(dk)
        with identical_trips(Sk // block_kv, q) as nk:
            for k0 in range(0, nk * block_kv, block_kv):
                ks = slice(k0, k0 + block_kv)
                kb, vb = k[:, ks], v[:, ks]
                dkj = torch.zeros(kb.shape, dtype=torch.float32,
                                  device=q.device)
                dvj = torch.zeros_like(dkj)
                dqj = torch.empty_like(dq)
                with identical_trips(Sq // block_q, q) as nq:
                    for q0 in range(0, nq * block_q, block_q):
                        qs = slice(q0, q0 + block_q)
                        dqb, dkb, dvb = _grads_of_block(
                            q[:, qs], kb, vb, do[:, qs], L[..., qs],
                            delta[..., qs],
                            _block_bias(qp[qs], kp[ks], win_arr, causal),
                            scale, softcap)
                        dvj = dvj + dvb
                        dkj = dkj + dkb
                        dqj[:, qs] = dqb
                dq = dq + dqj            # the JAX package's order of sums
                dk[:, ks] = dkj
                dv[:, ks] = dvj
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None, None, None)


class BandedAttention(torch.autograd.Function):
    """Banded causal attention for a static sliding window, with a
    hand-written backward (the JAX package's ``_banded_fn``).

    Each query block of ``block_q`` rows attends only its ``band``-wide kv
    slice (band >= window + block_q - 1, clamped into range): O(S·band)
    work and memory instead of O(S²).  Neighbouring q blocks' slices
    overlap, so the backward adds each block's dk/dv into its slice.  On
    meta tensors under the operator counter, two q blocks run and count
    for all (``op_analysis.identical_trips``).
    """

    @staticmethod
    def forward(ctx, q, k, v, window, softcap, block_q, band):
        B, Sq, Hk, G, hd = q.shape
        Sk = k.shape[1]
        scale = hd ** -0.5
        out = torch.empty_like(q, dtype=v.dtype)
        L = torch.empty((B, Hk, G, Sq), dtype=torch.float32, device=q.device)
        with identical_trips(Sq // block_q, q) as nq:
            for i, q0 in enumerate(range(0, nq * block_q, block_q)):
                qs = slice(q0, q0 + block_q)
                kst = _band_start(i, block_q, band, Sk)
                ks = slice(kst, kst + band)
                s, _ = _capped(_scores(q[:, qs], k[:, ks], scale), softcap)
                s = s + _band_bias(q0, kst, block_q, band, window, q.device)
                m = s.amax(dim=-1)
                p = torch.exp(s - m[..., None])
                l = p.sum(dim=-1)
                lc = torch.clamp(l, min=1e-30)
                o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype),
                                 v[:, ks])
                out[:, qs] = o / lc.permute(0, 3, 1, 2)[..., None]
                L[..., qs] = m + torch.log(lc)
        ctx.save_for_backward(q, k, v, out, L)
        ctx.args = (window, softcap, block_q, band)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, L = ctx.saved_tensors
        window, softcap, block_q, band = ctx.args
        Sq, hd = q.shape[1], q.shape[-1]
        Sk = k.shape[1]
        scale = hd ** -0.5
        delta = _delta(do, out)
        dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
        dv = torch.zeros_like(dk)
        with identical_trips(Sq // block_q, q) as nq:
            for i, q0 in enumerate(range(0, nq * block_q, block_q)):
                qs = slice(q0, q0 + block_q)
                kst = _band_start(i, block_q, band, Sk)
                ks = slice(kst, kst + band)
                dqb, dkb, dvb = _grads_of_block(
                    q[:, qs], k[:, ks], v[:, ks], do[:, qs], L[..., qs],
                    delta[..., qs],
                    _band_bias(q0, kst, block_q, band, window, q.device),
                    scale, softcap)
                dq[:, qs] = dqb
                dk[:, ks] += dkb         # slices overlap: add, never assign
                dv[:, ks] += dvb
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None, None)


def _band_start(i: int, block_q: int, band: int, Sk: int) -> int:
    return min(max((i + 1) * block_q - band, 0), Sk - band)


def _band_bias(q0: int, kstart: int, bq: int, bd: int, window: int, device):
    qp = q0 + torch.arange(bq, device=device)[:, None]
    kp = kstart + torch.arange(bd, device=device)[None, :]
    return _bias((kp <= qp) & (qp - kp < window))


def attend_blocked(q, k, v, *, causal, window, softcap, block_q: int = 512,
                   block_kv: int = 1024, local_flag=None, kv_valid_len=None):
    """Flash-style attention in PyTorch ops (hand-written backward passes,
    O(S·hd) saved).  q:[B,Sq,Hk,G,hd]; k,v:[B,Sk,Hk,hd]; positions are
    token order.  ``kv_valid_len`` falls back to dense attention; a static
    causal window over a square score matrix takes the banded path when the
    band is shorter than the keys.  On DTensors the blocks run on each
    device's shards of batch and KV heads (``shard_local``): the blocks
    need no collective, and DTensor's dispatch of each block's ops would
    cost more than the ops."""
    if is_dtensor(q) and kv_valid_len is None:
        return shard_local(
            lambda q_, k_, v_: attend_blocked(
                q_, k_, v_, causal=causal, window=window, softcap=softcap,
                block_q=block_q, block_kv=block_kv, local_flag=local_flag),
            q, k, v, dims=(0, 2))
    B, Sq, Hk, G, hd = q.shape
    Sk = k.shape[1]
    block_q = min(block_q, Sq)
    block_kv = min(block_kv, Sk)
    if Sq % block_q or Sk % block_kv:
        raise ValueError(f"blocked attention needs whole blocks: Sq {Sq}, "
                         f"Sk {Sk}, block_q {block_q}, block_kv {block_kv}")
    if kv_valid_len is not None:
        return attend_full(q, k, v, q_pos=torch.arange(Sq, device=q.device),
                           k_pos=torch.arange(Sk, device=q.device),
                           causal=causal, window=window, softcap=softcap,
                           local_flag=local_flag, kv_valid_len=kv_valid_len)
    if causal and window is not None and local_flag is None and Sq == Sk:
        nb = -(-(window + block_q - 1) // block_kv)
        band = nb * block_kv
        if band < Sk:
            return BandedAttention.apply(q, k, v, int(window), softcap,
                                         block_q, band)
    return BlockedFlash.apply(q, k, v, _win_arr(window, local_flag, q.device),
                              bool(causal), softcap, block_q, block_kv)


def attend_decode(q, k_cache, v_cache, *, cur_pos, window, softcap,
                  local_flag=None):
    """Single-token decode: q:[B,1,Hk,G,hd]; caches [B,T,Hk,hd]; cur_pos [B]."""
    scale = q.shape[-1] ** -0.5
    T = k_cache.shape[1]
    logits = torch.einsum("bqhgd,bkhd->bhgqk", q.float(),
                          k_cache.float()) * scale
    logits = _softcap(logits, softcap)
    kp = torch.arange(T, device=q.device)[None, :]   # [1,T]
    cp = cur_pos[:, None]                            # [B,1]
    ok = kp <= cp
    if window is not None:
        win_ok = cp - kp < window
        if local_flag is not None:
            win_ok = win_ok | ~torch.as_tensor(local_flag, device=q.device)
        ok = ok & win_ok
    logits = logits + _bias(ok)[:, None, None, None, :]
    # softmax over the keys spelled out (max, exp, sum): on a
    # length-sharded DTensor cache the logits reduce their [.., 1]
    # statistics across the shards, as GSPMD partitions the JAX package's
    # softmax, where DTensor's ``softmax`` would gather them
    e = (logits - logits.amax(dim=-1, keepdim=True)).exp()
    probs = (e / e.sum(dim=-1, keepdim=True)).to(v_cache.dtype)
    return torch.einsum("bhgqk,bkhd->bqhgd", probs, v_cache)


# ---------------------------------------------------------------------------
# Attention module (projections + cache plumbing)
# ---------------------------------------------------------------------------

def def_attention(cfg: ModelConfig) -> Dict[str, Any]:
    d, hq, hk, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p: Dict[str, Any] = {
        "wq": PDef((d, hq, hd), ("embed", "heads", "head_dim"), init="scaled"),
        "wk": PDef((d, hk, hd), ("embed", "kv_heads", "head_dim"), init="scaled"),
        "wv": PDef((d, hk, hd), ("embed", "kv_heads", "head_dim"), init="scaled"),
        "wo": PDef((hq, hd, d), ("heads", "head_dim", "embed"), init="scaled"),
    }
    if cfg.attn.qkv_bias:
        p["bq"] = PDef((hq, hd), ("heads", "head_dim"), init="zeros")
        p["bk"] = PDef((hk, hd), ("kv_heads", "head_dim"), init="zeros")
        p["bv"] = PDef((hk, hd), ("kv_heads", "head_dim"), init="zeros")
    return p


class AttnRun(NamedTuple):
    impl: str = "auto"          # auto | full | blocked | cuda
    block_q: int = 512
    block_kv: int = 1024
    blocked_threshold: int = 2048


def _project(x, w):
    """x [B,S,D] @ w [D,H,hd] -> [B,S,H,hd]."""
    B, S, _ = x.shape
    w = merge_ready(w.to(x.dtype), 1, w.dim())
    return seq_product(x, w.flatten(1)).view(B, S, *w.shape[1:])


def attention(p, x, *, cfg: ModelConfig, positions, is_local=False,
              run: AttnRun = AttnRun(),
              cache: Optional[Dict[str, torch.Tensor]] = None,
              decode: bool = False, causal: bool = True):
    """Returns (out [B,S,D], updated cache or None).

    * train/prefill: causal self-attention over x; fills cache when given.
    * decode: x is [B,1,D]; attends over cache; ``cache["pos"]`` is [B].
      The new K/V entries are written into the given cache tensors in place.
    """
    B, S, D = x.shape
    hq, hk, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    G = hq // hk
    a = cfg.attn
    if isinstance(is_local, bool):                 # static layer pattern
        window, local_flag = (a.sliding_window if is_local else None), None
    else:                                          # a flag tensor
        window, local_flag = a.sliding_window, is_local

    q = _project(x, p["wq"])
    k = _project(x, p["wk"])
    v = _project(x, p["wv"])
    if a.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)

    rope_pos = positions
    if a.mrope_sections is not None and positions.dim() == 2:
        rope_pos = positions[None].expand((3,) + tuple(positions.shape))
    q = apply_rope(q, rope_pos, a.rope_theta, a.mrope_sections)
    k = apply_rope(k, rope_pos, a.rope_theta, a.mrope_sections)

    q = shard(q, "batch", "seq", "act_heads", "head_dim")
    k = shard(k, "batch", "seq", "act_kv_heads", "head_dim")
    v = shard(v, "batch", "seq", "act_kv_heads", "head_dim")
    qg, ka, va = _grouped(q, k, v, hk)

    if decode:
        if cache is None or S != 1:
            raise ValueError("decode attends one token against a cache")
        pos = cache["pos"]                                     # [B]
        k_cache = _cache_write(cache["k"], k, pos)
        v_cache = _cache_write(cache["v"], v, pos)
        out = attend_decode(qg, k_cache, v_cache, cur_pos=pos,
                            window=window, local_flag=local_flag,
                            softcap=a.logit_softcap)
        new_cache = {"k": k_cache, "v": v_cache, "pos": pos + 1}
    else:
        impl = run.impl
        if impl == "auto":
            impl = "blocked" if S > run.blocked_threshold else "full"
        # Masks follow token order (RoPE positions may repeat, e.g. M-RoPE).
        q_pos = torch.arange(S, device=x.device)
        if impl == "full":
            out = attend_full(qg, ka, va, q_pos=q_pos, k_pos=q_pos,
                              causal=causal, window=window,
                              local_flag=local_flag,
                              softcap=a.logit_softcap)
        elif impl == "cuda":
            from repro_torch.kernels import flash_attention as fa
            if local_flag is not None:
                raise ValueError("attn_impl='cuda' takes a static window: "
                                 "pass is_local as a bool")
            # ``causal`` is passed through: the JAX package's "pallas"
            # path always masks causally, also in the encoder, which asks
            # for no mask (a fault the port does not copy)
            out = fa.ops.flash_attention_grouped(
                qg, k, v, causal=causal, window=window,
                softcap=a.logit_softcap,
                block_q=run.block_q, block_kv=run.block_kv)
        elif impl == "blocked":
            out = attend_blocked(qg, ka, va, causal=causal, window=window,
                                 local_flag=local_flag,
                                 softcap=a.logit_softcap,
                                 block_q=run.block_q, block_kv=run.block_kv)
        else:
            raise ValueError(f"unknown attention impl {impl!r}")
        new_cache = None
        if cache is not None:  # prefill fills the cache
            T = cache["k"].shape[1]
            kpad = _pad_to(k, T).to(cache["k"].dtype)
            vpad = _pad_to(v, T).to(cache["v"].dtype)
            new_cache = {"k": shard(kpad, "batch", "cache_seq", None, "head_dim"),
                         "v": shard(vpad, "batch", "cache_seq", None, "head_dim"),
                         "pos": torch.full((B,), S, dtype=torch.int32,
                                           device=x.device)}

    out = out.reshape(B, S, hq * hd)
    out = seq_product(out, merge_ready(p["wo"].to(x.dtype), 0, 2).reshape(
        hq * hd, D))
    return out, new_cache


def _grouped(q, k, v, hk: int):
    """(q [B,S,Hk,G,hd], k, v [B,S,Hk,hd]) for grouped-query attention.
    On DTensors whose query heads are sharded over more devices than
    there are KV heads (Qwen2-72B: 64 query and 8 KV heads on a model
    axis of 16), which no split of the query heads into (KV head, group)
    can keep, each query head gets its own copy of its KV head (G = 1):
    a local copy of the replicated k and v, laid out as the query heads."""
    B, S, hq, hd = q.shape
    G = hq // hk
    n = 1
    if is_dtensor(q):
        for i, p in enumerate(q.placements):
            if p.is_shard(2):
                n *= q.device_mesh.size(i)
    if hk % n == 0:
        return q.reshape(B, S, hk, G, hd), k, v

    def per_head(t):
        t = t[:, :, :, None].expand(B, S, hk, G, hd).reshape(B, S, hq, hd)
        return match_placements(t, q)
    return q.reshape(B, S, hq, 1, hd), per_head(k), per_head(v)


def _cache_write(cache_arr, new_kv, pos):
    """Write [B,1,H,hd] into [B,T,H,hd] at per-batch position ``pos``, in
    place, and return ``cache_arr``.

    Updating the cache in place saves a cache-sized copy a layer and a step
    (the JAX package gets the same from XLA's in-place scatter into the
    donated buffer).  As the JAX package's ``mode="drop"`` scatter does, a
    write at ``pos >= T`` is skipped, not an index error.  Into a DTensor
    cache each device writes the rows and positions its shard holds, with
    no collective, as GSPMD partitions the JAX package's scatter into a
    length-sharded cache: the new entries are laid out as the cache is but
    along its length (replicated there), the positions as its rows."""
    arr, offset = local_shard(cache_arr)
    upd = local_like(new_kv, cache_arr, (0, 2, 3)).to(arr.dtype)[:, 0]
    p = local_like(pos, cache_arr, (0,)) - offset[1]          # local slots
    keep = (p >= 0) & (p < arr.shape[1])
    # no boolean indexing, which would wait for the device: a dropped row
    # writes its own current entry back
    rows = torch.arange(arr.shape[0], device=arr.device)
    idx = torch.where(keep, p, 0).long()
    arr[rows, idx] = torch.where(keep[:, None, None], upd, arr[rows, idx])
    return cache_arr


def _pad_to(x, T):
    S = x.shape[1]
    if S == T:
        return x
    if S > T:
        raise ValueError(f"sequence of {S} does not fit a cache of {T}")
    return F.pad(x, (0, 0) * (x.dim() - 2) + (0, T - S))


# ---------------------------------------------------------------------------
# MLP (SwiGLU)
# ---------------------------------------------------------------------------

def def_mlp(d: int, f: int) -> Dict[str, PDef]:
    return {
        "wi_gate": PDef((d, f), ("embed", "ff"), init="scaled"),
        "wi_up": PDef((d, f), ("embed", "ff"), init="scaled"),
        "wo": PDef((f, d), ("ff", "embed"), init="scaled"),
    }


def mlp(p, x):
    h = F.silu(seq_product(x, p["wi_gate"].to(x.dtype))) * seq_product(
        x, p["wi_up"].to(x.dtype))
    h = shard(h, "batch", "seq", "act_ff")
    return seq_product(h, p["wo"].to(x.dtype))

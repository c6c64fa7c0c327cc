"""Mamba-2 (SSD — state-space duality) block.

Training and prefill use the chunked matmul ("SSD") form of
arXiv:2405.21060: within a chunk the recurrence is expanded into
attention-like products; across chunks a small [H, P, N] state is carried
by a loop over the chunks (the JAX package's ``lax.scan``).  Decode is the
O(1) recurrence step on a persistent (conv window, SSM state) cache.
Plain PyTorch, as the JAX package's is plain XLA: no Pallas kernel stands
behind it.

The depthwise causal convolution is the JAX package's sum of shifted
products, not ``F.conv1d``: cuDNN runs float32 convolutions in TF32 unless
told not to.  A pure recurrent oracle (``ssd_reference``) is kept for
tests: the chunked form must match it to float32 tolerance.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.op_analysis import close_trip, open_trip
from repro_torch.device import DeviceLike, resolve
from repro_torch.models.params import PDef
from repro_torch.parallel.sharding import shard


# ---------------------------------------------------------------------------
# Parameter defs
# ---------------------------------------------------------------------------

def def_mamba2(cfg: ModelConfig) -> Dict[str, Any]:
    s = cfg.ssm
    d = cfg.d_model
    di = cfg.d_inner
    nh = cfg.ssm_heads
    G, N = s.ngroups, s.state_dim
    conv_ch = di + 2 * G * N
    return {
        # in_proj -> [z (di), x (di), B (G*N), C (G*N), dt (nh)]
        "in_proj": PDef((d, 2 * di + 2 * G * N + nh), ("embed", "ssm_inner"),
                        init="scaled"),
        "conv_w": PDef((s.conv_dim, conv_ch), (None, "ssm_inner"), init="scaled"),
        "conv_b": PDef((conv_ch,), ("ssm_inner",), init="zeros"),
        "A_log": PDef((nh,), ("ssm_heads",), init="ones"),
        "dt_bias": PDef((nh,), ("ssm_heads",), init="zeros"),
        "D": PDef((nh,), ("ssm_heads",), init="ones"),
        "norm": PDef((di,), ("ssm_inner",), init="zeros"),
        "out_proj": PDef((di, d), ("ssm_inner", "embed"), init="scaled"),
    }


# ---------------------------------------------------------------------------
# Core SSD math
# ---------------------------------------------------------------------------

def _split_proj(cfg: ModelConfig, proj):
    s = cfg.ssm
    di, nh = cfg.d_inner, cfg.ssm_heads
    GN = s.ngroups * s.state_dim
    z, xc, Bc, Cc, dt = torch.split(proj, [di, di, GN, GN, nh], dim=-1)
    return z, xc, Bc, Cc, dt


def _causal_conv(xBC, w, b, state: Optional[torch.Tensor] = None):
    """Depthwise causal conv, width K.  xBC: [B,L,ch]; w: [K,ch].

    ``state``: [B, K-1, ch] trailing context (decode); returns (out, new_state).
    """
    K = w.shape[0]
    L = xBC.shape[1]
    if state is None:
        pad = xBC.new_zeros((xBC.shape[0], K - 1, xBC.shape[2]))
    else:
        pad = state.to(xBC.dtype)
    xp = torch.cat([pad, xBC], dim=1)                        # [B, L+K-1, ch]
    out = sum(xp[:, i:i + L, :] * w[i][None, None, :] for i in range(K))
    out = out + b[None, None, :]
    new_state = xp[:, -(K - 1):, :] if K > 1 else pad[:, :0]
    return F.silu(out), new_state


def ssd_chunked(x, dt, A, Bm, Cm, *, chunk: int,
                initial_state: Optional[torch.Tensor] = None,
                return_state: bool = False):
    """Chunked SSD scan.

    x  : [B, L, H, P]   (inputs per head)
    dt : [B, L, H]      (positive step sizes, softplus+bias already applied)
    A  : [H]            (negative decay rates)
    Bm : [B, L, G, N]   Cm: [B, L, G, N]
    Returns y: [B, L, H, P] (+ final state [B,H,P,N] if requested).
    """
    B, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if L % chunk != 0:
        # zero-pad to a chunk multiple: dt=0 rows are state-neutral
        # (decay = exp(0·A) = 1, contribution = dt·B⊗x = 0).
        pad = chunk - L % chunk
        out = ssd_chunked(F.pad(x, (0, 0, 0, 0, 0, pad)),
                          F.pad(dt, (0, 0, 0, pad)), A,
                          F.pad(Bm, (0, 0, 0, 0, 0, pad)),
                          F.pad(Cm, (0, 0, 0, 0, 0, pad)), chunk=chunk,
                          initial_state=initial_state,
                          return_state=return_state)
        if return_state:
            return out[0][:, :L], out[1]
        return out[:, :L]
    nc = L // chunk
    rep = H // G

    f32 = torch.float32
    xc = x.reshape(B, nc, chunk, H, P).to(f32)
    dtc = dt.reshape(B, nc, chunk, H).to(f32)
    BcH = Bm.reshape(B, nc, chunk, G, N).repeat_interleave(rep, dim=3).to(f32)
    CcH = Cm.reshape(B, nc, chunk, G, N).repeat_interleave(rep, dim=3).to(f32)

    dA = dtc * A.to(f32)[None, None, None, :]                # [B,nc,Q,H] (<=0)
    cum = torch.cumsum(dA, dim=2)                            # within-chunk cumsum
    seg_total = cum[:, :, -1, :]                             # [B,nc,H]

    # --- intra-chunk (quadratic in chunk, matmul form) ----------------------
    # L_mat[i,j] = exp(cum_i - cum_j) for i>=j else 0.  The mask goes in
    # before the exp: above the diagonal cum_i - cum_j >= 0 can overflow to
    # inf, and the JAX package's where-after-exp then sends 0 * inf = NaN
    # into every gradient (the same values forward).
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # [B,nc,Q,Q,H]
    ii = torch.arange(chunk, device=x.device)
    causal = (ii[:, None] >= ii[None, :])[None, None, :, :, None]
    Lmat = torch.exp(diff.masked_fill_(~causal, float("-inf")))  # f32
    del diff
    CB = torch.einsum("bcihn,bcjhn->bcijh", CcH, BcH)
    W = CB * Lmat * dtc[:, :, None, :, :]                    # [B,nc,Q,Q,H]
    del CB, Lmat
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", W, xc)
    del W

    # --- chunk states -------------------------------------------------------
    decay_to_end = torch.exp(seg_total[:, :, None, :] - cum)  # [B,nc,Q,H]
    states = torch.einsum("bcqh,bcqhn,bcqhp->bchpn",
                          decay_to_end * dtc, BcH, xc)

    # --- inter-chunk recurrence over nc -------------------------------------
    if initial_state is None:
        s = torch.zeros((B, H, P, N), dtype=f32, device=x.device)
    else:
        s = initial_state.to(f32)
    s_in = []
    for c in range(nc):
        if nc > 1:                  # the JAX package's scan: a trip a chunk
            s = open_trip(s, "ssd_chunks")
        s_in.append(s)                                       # entering chunk c
        s = s * torch.exp(seg_total[:, c])[:, :, None, None] + states[:, c]
        if nc > 1:
            s = close_trip(s, "ssd_chunks")
    s_in = torch.stack(s_in, dim=1)                          # [B,nc,H,P,N]

    y_inter = torch.einsum("bcqhn,bchpn->bcqhp",
                           CcH * torch.exp(cum)[..., None], s_in)
    y = (y_intra + y_inter).reshape(B, L, H, P).to(x.dtype)
    if return_state:
        return y, s
    return y


def ssd_reference(x, dt, A, Bm, Cm, initial_state=None):
    """O(L) recurrent oracle (slow; tests only)."""
    B, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    f32 = torch.float32
    s = torch.zeros((B, H, P, N), dtype=f32, device=x.device) \
        if initial_state is None else initial_state.to(f32)
    BmH = Bm.repeat_interleave(rep, dim=2).to(f32)
    CmH = Cm.repeat_interleave(rep, dim=2).to(f32)
    xf, dtf, Af = x.to(f32), dt.to(f32), A.to(f32)
    ys = []
    for t in range(L):
        dtt = dtf[:, t]                                      # [B,H]
        decay = torch.exp(dtt * Af[None, :])
        s = s * decay[:, :, None, None] + torch.einsum(
            "bh,bhn,bhp->bhpn", dtt, BmH[:, t], xf[:, t])
        ys.append(torch.einsum("bhn,bhpn->bhp", CmH[:, t], s))
    return torch.stack(ys, dim=1).to(x.dtype), s


# ---------------------------------------------------------------------------
# Full block
# ---------------------------------------------------------------------------

def _gated_norm(p, y, z, eps=1e-6):
    y = y * F.silu(z)
    dt = y.dtype
    yf = y.float()
    var = yf.square().mean(dim=-1, keepdim=True)
    return ((yf * torch.rsqrt(var + eps)) *
            (1.0 + p["norm"].float())).to(dt)


def mamba2_block(p, x, *, cfg: ModelConfig,
                 cache: Optional[Dict[str, torch.Tensor]] = None,
                 decode: bool = False):
    """x: [B,S,D] -> (out [B,S,D], new cache or None).

    cache = {"conv": [B, K-1, ch], "ssm": [B, H, P, N]}
    """
    s = cfg.ssm
    B, S, D = x.shape
    di, nh = cfg.d_inner, cfg.ssm_heads
    G, N, P_ = s.ngroups, s.state_dim, s.head_dim

    proj = x @ p["in_proj"].to(x.dtype)
    z, xi, Bc, Cc, dt_raw = _split_proj(cfg, proj)
    xBC = torch.cat([xi, Bc, Cc], dim=-1)

    A = -torch.exp(p["A_log"].float())
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())    # [B,S,nh]

    if decode:
        if cache is None or S != 1:
            raise ValueError("decode steps one token against a cache")
        xBC, conv_state = _causal_conv(xBC, p["conv_w"].to(x.dtype),
                                       p["conv_b"].to(x.dtype),
                                       state=cache["conv"])
        xi, Bc, Cc = torch.split(xBC, [di, G * N, G * N], dim=-1)
        xh = xi.reshape(B, nh, P_)
        Bh = Bc.reshape(B, G, N).repeat_interleave(nh // G, dim=1)
        Ch = Cc.reshape(B, G, N).repeat_interleave(nh // G, dim=1)
        dt1 = dt[:, 0, :]                                    # [B,nh]
        decay = torch.exp(dt1 * A[None, :])
        ssm = cache["ssm"].float()
        ssm = ssm * decay[:, :, None, None] + torch.einsum(
            "bh,bhn,bhp->bhpn", dt1, Bh.float(), xh.float())
        y = torch.einsum("bhn,bhpn->bhp", Ch.float(), ssm)
        y = y + p["D"].float()[None, :, None] * xh.float()
        y = y.reshape(B, 1, di).to(x.dtype)
        new_cache = {"conv": conv_state, "ssm": ssm}
    else:
        xBC, conv_tail = _causal_conv(xBC, p["conv_w"].to(x.dtype),
                                      p["conv_b"].to(x.dtype))
        xi, Bc, Cc = torch.split(xBC, [di, G * N, G * N], dim=-1)
        xh = xi.reshape(B, S, nh, P_)
        xh = shard(xh, "batch", "seq", "act_ssm_heads", None)
        Bh = Bc.reshape(B, S, G, N)
        Ch = Cc.reshape(B, S, G, N)
        want_state = cache is not None
        out = ssd_chunked(xh, dt, A, Bh, Ch, chunk=min(s.chunk_size, S),
                          return_state=want_state)
        if want_state:
            y4, ssm_state = out
        else:
            y4 = out
        y4 = y4 + p["D"].to(y4.dtype)[None, None, :, None] * xh
        y = y4.reshape(B, S, di)
        new_cache = None
        if want_state:
            new_cache = {"conv": conv_tail, "ssm": ssm_state}

    y = _gated_norm(p, y, z)
    return y @ p["out_proj"].to(x.dtype), new_cache


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device: DeviceLike = None):
    """One layer's cache {conv: [B, K-1, ch] in ``dtype``, ssm: [B, H, P, N]
    in float32} on ``device`` (``"cuda"`` unless named)."""
    dev = resolve(device)
    s = cfg.ssm
    ch = cfg.d_inner + 2 * s.ngroups * s.state_dim
    return {
        "conv": shard(torch.zeros((batch, s.conv_dim - 1, ch), dtype=dtype,
                                  device=dev),
                      "batch", None, "act_ssm_inner"),
        "ssm": shard(torch.zeros((batch, cfg.ssm_heads, s.head_dim,
                                  s.state_dim), dtype=torch.float32,
                                 device=dev),
                     "batch", "act_ssm_heads", None, None),
    }

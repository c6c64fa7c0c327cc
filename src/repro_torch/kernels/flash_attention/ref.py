"""Plain PyTorch version of flash attention: dense softmax attention over the
[BH, S, hd] layout, as the JAX package's ``ref.flash_attention`` computes it.

Logits are accumulated in float32 (the inputs are upcast, which keeps every
product exact for bfloat16), masked with the finite ``NEG_INF`` (so a row
with no visible key averages every value, as the kernel does), and the
softmax probabilities are cast to v's dtype before the PV product.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    group: int = 1) -> torch.Tensor:
    BH, Sq, hd = q.shape
    if group > 1:
        k = k.repeat_interleave(group, dim=0)
        v = v.repeat_interleave(group, dim=0)
    Sk = k.shape[1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * hd ** -0.5
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    qp = torch.arange(Sq, device=q.device)[:, None]
    kp = torch.arange(Sk, device=q.device)[None, :]
    ok = (kp <= qp) if causal else torch.ones(
        (Sq, Sk), dtype=torch.bool, device=q.device)
    if window is not None:
        ok = ok & (qp - kp < window)
    s = s.masked_fill(~ok[None], NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p.to(v.dtype), v)


def flops(BH: int, Sq: int, Sk: int, hd: int, *, causal: bool = True,
          window: Optional[int] = None) -> float:
    """Matmul flops of the attention the mask leaves: 4 * hd per visible
    (query, key) pair (QK^T and PV, a multiply and an add each)."""
    pairs = 0
    for qp in range(Sq):
        hi = min(Sk - 1, qp) if causal else Sk - 1
        lo = max(0, qp - window + 1) if window is not None else 0
        pairs += max(0, hi - lo + 1)
    return 4.0 * BH * hd * pairs

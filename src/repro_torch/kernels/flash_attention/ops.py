"""Entry points; ``flash_attention_grouped`` matches the model-layer calling
convention (q [B,S,Hk,G,hd], k/v [B,S,Hk,hd]).

The layout moves are the JAX package's: the flat query head index is
``(b, hk, g)`` and the flat KV head index ``(b, hk)``, so query head ``h``
reads KV head ``h // G = b * Hk + hk``.
"""
from __future__ import annotations

from repro_torch.kernels.flash_attention.kernel import flash_attention


def flash_attention_grouped(qg, k, v, *, causal=True, window=None,
                            softcap=None, block_q=512, block_kv=512):
    """qg: [B,S,Hk,G,hd]; k/v: [B,S,Hk,hd] -> [B,S,Hk,G,hd]."""
    B, S, Hk, G, hd = qg.shape
    qf = qg.movedim(1, 3).reshape(B * Hk * G, S, hd)
    kf = k.movedim(1, 2).reshape(B * Hk, S, hd)
    vf = v.movedim(1, 2).reshape(B * Hk, S, hd)
    out = flash_attention(qf, kf, vf, causal=causal, window=window,
                          softcap=softcap, block_q=block_q,
                          block_kv=block_kv, group=G)
    return out.reshape(B, Hk, G, S, hd).movedim(3, 1)

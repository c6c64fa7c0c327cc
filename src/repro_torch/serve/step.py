"""Serving steps: prefill (builds the cache, returns first sampled token) and
decode (one token for the whole batch against the cache).  Greedy argmax
sampling, as in the JAX package; its sharding rules wait for the sharding
slice (ROADMAP.md queue 1, item 7h).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.model_zoo import Model


def greedy_token(model: Model, params, hidden_last):
    logits = model.logits(params, hidden_last)        # [B,1,V]
    # the first maximum on ties, as jnp.argmax takes it
    return torch.argmax(logits, dim=-1).to(torch.int32)   # [B,1]


def make_prefill_step(model: Model, max_len: int,
                      src_len: Optional[int] = None):
    """``src_len``: the encoder-decoder's source length for its cross cache
    (``max_len`` when None)."""
    def prefill_step(params, batch):
        leaf = batch.get("tokens", batch.get("tgt_tokens",
                                             batch.get("embeds")))
        B = leaf.shape[0]
        if model.cfg.family == "encdec":
            cache = model.init_cache(B, max_len, src_len=src_len,
                                     device=leaf.device)
        else:
            cache = model.init_cache(B, max_len, device=leaf.device)
        hidden, cache, _ = model.forward(params, batch, cache=cache)
        tok = greedy_token(model, params, hidden[:, -1:])
        return tok, cache
    return prefill_step


def make_decode_step(model: Model):
    def decode_step(params, tokens, cache):
        """One token; ``cache`` is updated in place and returned."""
        hidden, cache, _ = model.forward(params, {"tokens": tokens},
                                         cache=cache, decode=True)
        tok = greedy_token(model, params, hidden)
        return tok, cache
    return decode_step

"""Serving steps: prefill (builds the cache, returns first sampled token) and
decode (one token for the whole batch against the cache).  Greedy argmax
sampling, as in the JAX package.  With a mesh, each call runs under
``use_sharding`` with the prefill or decode rule table on parameters,
inputs and cache of DTensors; plain inputs are laid out along their
batch (``batch_laid``).
"""
from __future__ import annotations

from typing import Optional

from repro_torch.models.model_zoo import Model
from repro_torch.parallel.sharding import (DECODE_RULES, PREFILL_RULES,
                                           batch_laid, first_argmax,
                                           use_sharding)


def greedy_token(model: Model, params, hidden_last):
    logits = model.logits(params, hidden_last)        # [B,1,V]
    return first_argmax(logits)                       # [B,1] int32


def make_prefill_step(model: Model, max_len: int,
                      src_len: Optional[int] = None, mesh=None,
                      rules_table=PREFILL_RULES):
    """``src_len``: the encoder-decoder's source length for its cross cache
    (``max_len`` when None)."""
    def prefill_step(params, batch):
        with use_sharding(mesh, rules_table):
            batch = batch_laid(batch)
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


def make_decode_step(model: Model, mesh=None, rules_table=DECODE_RULES):
    def decode_step(params, tokens, cache):
        """One token; ``cache`` is updated in place and returned."""
        with use_sharding(mesh, rules_table):
            hidden, cache, _ = model.forward(params,
                                             {"tokens": batch_laid(tokens)},
                                             cache=cache, decode=True)
            tok = greedy_token(model, params, hidden)
            return tok, cache
    return decode_step

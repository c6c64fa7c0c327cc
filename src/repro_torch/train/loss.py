"""Cross-entropy loss, optionally chunked over the sequence so the full
[B, S, V] logits tensor never lives: each chunk runs under
``torch.utils.checkpoint``, so its [B, chunk, V] logits are freed after
its forward and recomputed in its backward (the JAX package's
``jax.checkpoint`` of its scan body).
"""
from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.op_analysis import close_trip, open_trip
from repro_torch.parallel.sharding import first_argmax


def _ce_block(logits, targets):
    """logits [.., V]; targets [..] int -> (sum loss, sum correct), f32.

    Spelled in maxima, sums and masks over V, with no ``logsumexp``,
    ``gather`` or ``argmax``: on vocab-sharded DTensor logits each of
    these reduces its [.., 1] statistics across the shards (a small
    all-reduce), as GSPMD partitions the JAX package's, where DTensor's
    own ``logsumexp`` and ``argmax`` would gather the logits."""
    logits = logits.float()
    V = logits.shape[-1]
    m = logits.detach().amax(dim=-1, keepdim=True)
    lse = (logits - m).exp().sum(dim=-1, keepdim=True).log() + m
    vocab = torch.arange(V, dtype=torch.int32, device=logits.device)
    hit = vocab == targets[..., None]
    tgt = torch.where(hit, logits, 0.0).sum(dim=-1, keepdim=True)
    loss = (lse - tgt).sum()
    correct = (first_argmax(logits, m) == targets).float().sum()
    return loss, correct


def cross_entropy(logits_fn, hidden, targets,
                  chunk: int = 0) -> Tuple[torch.Tensor, Dict]:
    """logits_fn(hidden_chunk) -> logits_chunk.  Returns (mean loss, metrics)."""
    B, S = targets.shape
    n_tok = B * S
    if chunk <= 0 or S <= chunk or S % chunk != 0:
        loss, correct = _ce_block(logits_fn(hidden), targets)
    else:
        def body(h, t):
            return _ce_block(logits_fn(h), t)

        if torch.is_grad_enabled():
            body = functools.partial(checkpoint, body, use_reentrant=False)
        loss = torch.zeros((), device=hidden.device)
        correct = torch.zeros((), device=hidden.device)
        # split once: the chunks' gradients meet in one concatenation
        for h, t in zip(hidden.split(chunk, dim=1),
                        targets.split(chunk, dim=1)):
            # the JAX package's scan: a trip a chunk, for the profiler
            h = open_trip(h, "loss_chunks")
            l, c = body(h, t)
            loss, correct = loss + l, correct + c
            loss = close_trip(loss, "loss_chunks")
    return loss / n_tok, {
        "accuracy": correct / n_tok,
        "tokens": torch.tensor(float(n_tok), device=hidden.device)}

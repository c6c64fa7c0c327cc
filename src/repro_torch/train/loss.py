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


def _ce_block(logits, targets):
    """logits [.., V]; targets [..] int -> (sum loss, sum correct), f32."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    loss = (lse - tgt).sum()
    # the first maximum on ties, as jnp.argmax takes it
    correct = (logits.argmax(dim=-1) == targets).float().sum()
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
        for c0 in range(0, S, chunk):
            l, c = body(hidden[:, c0:c0 + chunk], targets[:, c0:c0 + chunk])
            loss = loss + l
            correct = correct + c
    return loss / n_tok, {
        "accuracy": correct / n_tok,
        "tokens": torch.tensor(float(n_tok), device=hidden.device)}

"""Error-feedback int8 gradient compression (the JAX package's
``Int8ErrorFeedback``).

Quantizing the gradient to int8 with one scale a tensor cuts an all-reduce
payload 4x against f32.  Error feedback keeps the quantization residual in
the train state (``ef_error``) and adds it back next step, so compression
is unbiased in the long run.  ``torch.round`` rounds half to even, as
``jnp.round`` does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from repro_torch.models.params import map_tensors
from repro_torch.optim.adamw import tree_leaves


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp(x.abs().max(), min=1e-20) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


@dataclass(frozen=True)
class Int8ErrorFeedback:
    """Gradient compressor with persistent error state under key 'ef_error'."""

    def init_error(self, params):
        return map_tensors(params, lambda p: torch.zeros(
            p.shape, dtype=torch.float32, device=p.device))

    def apply(self, grads, state) -> Tuple[Any, Any, Dict]:
        def one(g, e):
            g32 = g.float() + e
            deq = dequantize_int8(*quantize_int8(g32))
            return deq, g32 - deq

        pairs = map_tensors(grads, one, state["ef_error"])
        new_grads = map_tensors(pairs, lambda t: t[0])
        new_err = map_tensors(pairs, lambda t: t[1])
        new_state = dict(state)
        new_state["ef_error"] = new_err
        err_norm = torch.sqrt(sum(e.square().sum()
                                  for e in tree_leaves(new_err)))
        return new_grads, new_state, {"ef_error_norm": err_norm}

    @staticmethod
    def wire_bytes_saved(params) -> float:
        """f32 all-reduce payload minus int8+scale payload, per step."""
        leaves = list(tree_leaves(params))
        total = sum(x.numel() for x in leaves)
        return 4.0 * total - (1.0 * total + 4.0 * len(leaves))


"""Run settings orthogonal to the architecture: dtypes and the attention
impl.  The serving fields of the JAX package's ``RunConfig``, with torch
dtypes.

``attn_impl`` (prefill attention):

  * ``full``    — dense softmax attention in PyTorch ops (``attend_full``).
  * ``cuda``    — the hand-written Hopper kernel ``csrc/flash_attention.cu``,
                  the counterpart of the JAX package's ``pallas``.
  * ``auto``    — the JAX package's rule: ``blocked`` above
                  ``blocked_threshold`` tokens, else ``full``.
  * ``blocked`` — not ported yet (``BLOCKED_TODO``).

The JAX package's fields for training and distribution (remat, loss
chunking, ZeRO-1, sharding, pipelining) come with the slices that read them
(ROADMAP.md queue 1, items 7b and 7h).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}

ATTN_IMPLS = ("auto", "full", "blocked", "cuda")

BLOCKED_TODO = ("attn_impl='blocked' (attend_blocked: the XLA flash and "
                "banded paths with custom VJPs) is not ported yet: ROADMAP.md "
                "queue 1, item 7b (blocked attention and training)")


@dataclass(frozen=True)
class RunConfig:
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    cache_dtype: str = "bfloat16"
    # attention
    attn_impl: str = "auto"              # auto | full | blocked | cuda
    block_q: int = 512
    block_kv: int = 1024
    blocked_threshold: int = 2048

    def __post_init__(self):
        if self.attn_impl not in ATTN_IMPLS:
            hint = " (the port's name for it is 'cuda')" \
                if self.attn_impl == "pallas" else ""
            raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got "
                             f"{self.attn_impl!r}{hint}")

    @property
    def pdtype(self):
        return _DTYPES[self.param_dtype]

    @property
    def cdtype(self):
        return _DTYPES[self.compute_dtype]

    @property
    def kvdtype(self):
        return _DTYPES[self.cache_dtype]


TRAIN_RUN = RunConfig()
SERVE_RUN = RunConfig(param_dtype="bfloat16")

"""Run settings orthogonal to the architecture: dtypes, the attention impl,
remat, loss chunking, microbatches and gradient compression.  The fields
of the JAX package's ``RunConfig`` that the port reads, with torch dtypes
and the JAX package's defaults.

``attn_impl`` (prefill and training attention):

  * ``full``    — dense softmax attention in PyTorch ops (``attend_full``).
  * ``blocked`` — flash-style blocked attention in PyTorch ops with
                  hand-written backward passes (``attend_blocked``):
                  O(S·hd) memory in the forward and the backward.
  * ``cuda``    — the hand-written Hopper kernel ``csrc/flash_attention.cu``,
                  the counterpart of the JAX package's ``pallas``
                  (forward only: it has no backward, as the JAX package's
                  kernel has no VJP).
  * ``auto``    — the JAX package's rule: ``blocked`` above
                  ``blocked_threshold`` tokens, else ``full``.

``remat`` (what the backward recomputes, per layer): ``none``; ``dots``,
which saves the outputs of matrix products with no batch dimension and
recomputes the rest; ``full``, which saves only the layer's input.

The JAX package's fields for distribution (``zero1``, ``sharding_mode``,
``pipeline_stages``, ``max_cache_len``) come with the sharding slice
(ROADMAP.md queue 1, item 7h).  ``skip_attn_blocks`` is not kept: the
JAX package's ``attend_blocked`` discards it.  ``moe_dense_smoke`` and
``grad_compression`` are kept and, as in the JAX package, read by
nothing: ``make_job(compress=)`` and ``train(compress=)`` are the only
switch for compression.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}

ATTN_IMPLS = ("auto", "full", "blocked", "cuda")
REMATS = ("none", "dots", "full")
GRAD_COMPRESSIONS = ("none", "int8_ef")


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
    # memory / remat
    remat: str = "full"                  # none | dots | full
    loss_chunk: int = 512                # 0 = unchunked [B,S,V] logits
    # optimizer
    grad_compression: str = "none"       # none | int8_ef
    microbatches: int = 1
    # moe
    moe_dense_smoke: bool = False        # tiny-model testing aid; unread

    def __post_init__(self):
        if self.attn_impl not in ATTN_IMPLS:
            hint = " (the port's name for it is 'cuda')" \
                if self.attn_impl == "pallas" else ""
            raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got "
                             f"{self.attn_impl!r}{hint}")
        if self.remat not in REMATS:
            raise ValueError(f"remat must be one of {REMATS}, got "
                             f"{self.remat!r}")
        if self.grad_compression not in GRAD_COMPRESSIONS:
            raise ValueError(f"grad_compression must be one of "
                             f"{GRAD_COMPRESSIONS}, got "
                             f"{self.grad_compression!r}")

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
SERVE_RUN = RunConfig(param_dtype="bfloat16", remat="none")

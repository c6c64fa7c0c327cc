"""Deterministic synthetic token pipeline — sharded, seedable, resumable.

Every batch is a function of ``(seed, step, shard_index)`` alone: numpy's
counter-based ``Philox`` bit generator is keyed on those three, so exact
resume needs only the step number in the checkpoint manifest, and each data
shard draws its own slice of the global batch with no coordination.

The "language" is the JAX package's order-1 Markov chain over the vocab,
``tokens[t+1] = (a * tokens[t] + b) mod V`` with probability ``structure``
(uniform noise otherwise), so cross-entropy has learnable structure.  The
chain is sequential, so the batch is built on the host, one numpy step a
position over the batch (a loop on the card would launch S times), and
moves to the device in one copy.

The JAX package draws from ``jax.random`` (threefry), so the token bits
differ between the two packages; only the rule and the interface are the
same.  Tests that hold the packages to each other give both one batch.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    structure: float = 0.8      # P(follow the Markov rule) vs uniform noise


class SyntheticLM:
    """tokens[t+1] = (a * tokens[t] + b) mod V with prob ``structure``;
    batches land on ``device`` (``"cuda"`` unless named)."""

    def __init__(self, cfg: DataConfig, device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve(device)
        v = cfg.vocab_size
        self.a = 31 % v or 1
        self.b = 17 % v

    def host_batch_at(self, step: int, *, shard_index: int = 0,
                      num_shards: int = 1) -> np.ndarray:
        """[2, b, S] int32 on the host: tokens, then targets."""
        cfg = self.cfg
        if cfg.global_batch % num_shards:
            raise ValueError(f"global batch {cfg.global_batch} does not "
                             f"split into {num_shards} shards")
        local_b = cfg.global_batch // num_shards
        key = (cfg.seed << 64) | (step << 32) | shard_index
        rng = np.random.Generator(np.random.Philox(key=key))
        v, S = cfg.vocab_size, cfg.seq_len
        seq = np.empty((local_b, S + 1), dtype=np.int64)
        seq[:, 0] = rng.integers(0, v, local_b)
        noise = rng.integers(0, v, (S, local_b))
        follow = rng.random((S, local_b)) < cfg.structure
        for t in range(S):
            seq[:, t + 1] = np.where(follow[t], (self.a * seq[:, t] + self.b)
                                     % v, noise[t])
        return np.stack([seq[:, :-1], seq[:, 1:]]).astype(np.int32)

    def batch_at(self, step: int, *, shard_index: int = 0,
                 num_shards: int = 1) -> Dict[str, torch.Tensor]:
        both = torch.from_numpy(self.host_batch_at(
            step, shard_index=shard_index, num_shards=num_shards)).to(
                self.device)
        return {"tokens": both[0], "targets": both[1]}

    def iterate(self, start_step: int = 0, *, shard_index: int = 0,
                num_shards: int = 1) -> Iterator[Dict[str, torch.Tensor]]:
        step = start_step
        while True:
            yield self.batch_at(step, shard_index=shard_index,
                                num_shards=num_shards)
            step += 1

    def state(self, step: int) -> Dict:
        """Everything needed for exact resume (goes into the ckpt manifest)."""
        return {"seed": self.cfg.seed, "step": step,
                "structure": self.cfg.structure}

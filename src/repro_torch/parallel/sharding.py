"""Logical-axis activation constraints.

Model code names axes logically (``shard(x, "batch", "seq_shard", None)``),
as in the JAX package.  Outside a sharding context the JAX package's
``shard`` returns its input, and the port has no sharding context yet:
rules, meshes and ``use_sharding`` come with the sharding slice
(ROADMAP.md queue 1, item 7h).
"""
from __future__ import annotations

from typing import Optional


def shard(x, *axes: Optional[str]):
    """Constrain activation ``x`` to logical ``axes``: ``x`` itself, as the
    JAX package's ``shard`` is outside a sharding context."""
    del axes
    return x

"""Device meshes for the collective atom.

A ``Mesh`` names its axes and their sizes, as the JAX package's
``jax.make_mesh`` does, and holds one ``torch.device`` a shard in
``devices`` (a numpy object array in the mesh's shape).  One process owns
every shard of its mesh (a single controller, as in the JAX package).  In
this package every shard of a mesh lives on ONE device, the card or the
CPU: the counterpart of the JAX package's forced host devices.  The mesh
says so (``shared``), and its shards are one tensor of shape
``(*shape.values(), block)`` on that device, a collective running along
the dimension of its axis.  Shard ids are 0 .. N-1 in the mesh's order,
where the JAX package uses each device's ``id``, so plan keys that name a
mesh are the same tuple in both packages.  Shards on distinct cards are
not built here.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve


class Mesh:
    """A named device mesh whose shards all live on ``device``."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str],
                 device: DeviceLike = None):
        shape, axes = tuple(int(s) for s in shape), tuple(axes)
        if len(shape) != len(axes) or not shape:
            raise ValueError(f"mesh shape {shape} and axes {axes} must be "
                             "equal-length and non-empty")
        if min(shape) < 1 or len(set(axes)) != len(axes):
            raise ValueError(f"mesh axes {axes} must be distinct and their "
                             f"sizes {shape} at least 1")
        self.device = resolve(device)
        self.axis_names: Tuple[str, ...] = axes
        #: axis -> size, in axis order (``jax.sharding.Mesh.shape``)
        self.shape: Dict[str, int] = dict(zip(axes, shape))
        self.devices = np.empty(shape, dtype=object)
        for idx in np.ndindex(*shape):
            self.devices[idx] = self.device
        #: every shard on one device
        self.shared = True

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def shard_ids(self) -> Tuple[int, ...]:
        """0 .. N-1 in the mesh's order (the JAX package's ``d.id``)."""
        return tuple(range(self.size))

    def dim(self, axis: str) -> int:
        """The dimension of the shards' tensor that ``axis`` runs along."""
        return self.axis_names.index(axis)

    def __repr__(self) -> str:
        return (f"Mesh({describe(self)}, device={self.device}, "
                f"shared={self.shared})")


def make_mesh(shape, axes, device: DeviceLike = None) -> Mesh:
    """A mesh of ``shape`` named ``axes`` with every shard on ``device``
    (``"cuda"`` unless named)."""
    return Mesh(shape, axes, device)


def describe(mesh) -> dict:
    return {name: int(size) for name, size in
            zip(mesh.axis_names, mesh.devices.shape)}

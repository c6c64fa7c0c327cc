"""Device meshes: which hold shards on distinct ranks, and which do not.

* ``make_mesh``: the collective atom's ``Mesh``.  It names its axes and
  their sizes, as the JAX package's ``jax.make_mesh`` does, and holds one
  ``torch.device`` a shard in ``devices`` (a numpy object array in the
  mesh's shape).  One process owns every shard of its mesh (a single
  controller, as in the JAX package), and every shard lives on ONE
  device, the card or the CPU: the counterpart of the JAX package's
  forced host devices.  The mesh says so (``shared``), and its shards are
  one tensor of shape ``(*shape.values(), block)`` on that device, a
  collective running along the dimension of its axis.  Shard ids are
  0 .. N-1 in the mesh's order, where the JAX package uses each device's
  ``id``, so plan keys that name a mesh are the same tuple in both
  packages.
* ``fake_device_mesh`` and ``make_production_mesh``: ``DeviceMesh``es
  over fake process groups of 256 or 512 ranks, for the dry-run; their
  shards are meta tensors of this process, and no collective moves data.
* Shards on distinct ranks, each rank a process holding its own shards on
  its own device, joined by a real process group, are built in
  ``repro_torch.launch.world``: ``RankMesh`` (a ``Mesh`` with ``shared``
  False, for the collective atom) and ``device_mesh`` (a ``DeviceMesh``,
  for the sharded train and serve steps).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve
from repro_torch.parallel.sharding import mesh_axes


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


def fake_world(size: int) -> None:
    """Make the default process group a fake one of ``size`` ranks, this
    process rank 0, unless it already is.  One process holds one default
    group, so a group of another size replaces it (and every mesh built
    on the old one)."""
    import torch.distributed as dist
    # the import registers the "fake" backend with torch.distributed
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == size:
            return
        dist.destroy_process_group()
    _FAKE_MESHES.clear()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)


def close_fake_world() -> None:
    """End the fake process group ``fake_world`` made, and its meshes."""
    import torch.distributed as dist
    _FAKE_MESHES.clear()
    if dist.is_initialized() and dist.get_backend() == "fake":
        dist.destroy_process_group()


#: (shape, axes, device type) -> DeviceMesh on the current fake group:
#: one mesh a layout, so DTensor's sharding caches, keyed by mesh, serve every cell
_FAKE_MESHES: Dict[tuple, object] = {}


def fake_device_mesh(shape: Sequence[int], axes: Sequence[str],
                     device_type: Optional[str] = None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over a fake process
    group of ``prod(shape)`` ranks (``fake_world``), of ``device_type``
    (``fake_device_type()`` unless named).  Its tensors' shards live on
    the CPU or on meta; no collective moves data."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    device_type = device_type or fake_device_type()
    fake_world(math.prod(shape))
    key = (shape, axes, device_type)
    if key not in _FAKE_MESHES:
        _FAKE_MESHES[key] = init_device_mesh(device_type, shape,
                                             mesh_dim_names=axes)
    return _FAKE_MESHES[key]


def fake_device_type() -> str:
    """The device type of a fake mesh unless one is named: "cuda", the
    kind of a production mesh's devices, where a card is present (nothing
    touches it: the shards are meta tensors); else "cpu".  The two lay
    some steps out differently: on a "cpu" mesh DTensor moves a tensor
    between two sharded dims with an all-gather and a chunk, where a
    "cuda" one uses an all-to-all (gloo has none), so a step's collective
    and temporary bytes depend on it, and the dry-run's artifacts record
    it (``mesh_device_type``).  DTensor's sharding propagation cannot run
    every backward op on fake "cuda" tensors where no card is present."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None):
    """The JAX package's production mesh: (16, 16) named ("data", "model"),
    or (2, 16, 16) named ("pod", "data", "model"), as a fake
    ``DeviceMesh`` of 256 or 512 ranks (``fake_device_mesh``).  No card
    holds such a mesh: the dry-run lays meta tensors out on it."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return fake_device_mesh(shape, axes, device_type)


def describe(mesh) -> dict:
    """Axis name -> size, of a ``Mesh`` or a ``DeviceMesh``."""
    return mesh_axes(mesh)

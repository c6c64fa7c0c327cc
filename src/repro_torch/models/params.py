"""Parameter definition trees.

A model is described once as a nested dict of ``PDef`` leaves (shape, logical
axes, initializer), as in the JAX package.  From that single source the port
derives:

  * materialized parameters          (``init_params``)
  * PartitionSpecs                   (``spec_tree``)
  * tensors with no data for the dry-run (``abstract_params``: meta
    tensors, or DTensors with meta shards on a mesh)

and the parameter count; ``from_numpy`` carries the JAX package's
parameters across, and ``train_state_from_numpy`` its train state.
Logical axis names are resolved to mesh axes by
``repro_torch.parallel.sharding`` rules.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve
from repro_torch.parallel.sharding import abstract_tensor


@dataclass(frozen=True)
class PDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"            # normal | zeros | ones | scaled | small
    scale: float = 1.0              # multiplier on the initializer
    dtype: Optional[Any] = None     # override the tree-wide param dtype

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"PDef shape {self.shape} and axes "
                             f"{self.axes} differ in rank")


def is_pdef(x) -> bool:
    return isinstance(x, PDef)


def _tree_map(tree, fn, path=()):
    if is_pdef(tree):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: _tree_map(v, fn, path + (k,)) for k, v in tree.items()}
    raise TypeError(f"bad pdef tree node at {path}: {type(tree)}")


def map_tensors(tree, fn, *others):
    """Apply ``fn`` to every leaf of a nested dict of tensors or arrays;
    with ``others`` (trees of the same keys), to every leaf and its
    counterparts: ``fn(leaf, *other_leaves)``."""
    if isinstance(tree, dict):
        return {k: map_tensors(v, fn, *(o[k] for o in others))
                for k, v in tree.items()}
    return fn(tree, *others)


def _materialize(gen: torch.Generator, pd: PDef, dtype, device):
    dt = pd.dtype or dtype
    if pd.init == "zeros":
        return torch.zeros(pd.shape, dtype=dt, device=device)
    if pd.init == "ones":
        return torch.ones(pd.shape, dtype=dt, device=device)
    if pd.init == "normal":
        std = pd.scale * 0.02
    elif pd.init == "scaled":  # fan-in scaled: the leading dim, as the JAX
        # package takes it (the layer count, for stacked leaves)
        fan_in = pd.shape[0] if len(pd.shape) >= 2 else max(pd.shape[0], 1)
        std = pd.scale / np.sqrt(fan_in)
    elif pd.init == "small":
        std = pd.scale * 1e-3
    else:
        raise ValueError(pd.init)
    x = torch.randn(pd.shape, generator=gen, dtype=dt, device=device)
    return x.mul_(std)


def init_params(tree, generator: torch.Generator, dtype=torch.float32,
                device: DeviceLike = None):
    """Materialize a PDef tree on ``device`` (``"cuda"`` unless named),
    drawing the leaves in the tree's order from ``generator``, which must
    live on that device.  The initializers are the JAX package's (the same
    distributions, not the same numbers: carry weights across with
    ``from_numpy``)."""
    dev = resolve(device)
    if torch.device(generator.device).type != dev.type:
        raise ValueError(f"init_params: the generator is on "
                         f"{generator.device}, the parameters go to {dev}")
    return _tree_map(
        tree, lambda path, pd: _materialize(generator, pd, dtype, dev))


def spec_tree(tree, rules):
    """PDef tree -> PartitionSpec tree via logical-axis rules.

    Divisibility-checked with row-parallel TP fallback (see
    Rules.pspec_checked): head counts that don't divide the model axis fall
    back to sharding d_model.
    """
    return _tree_map(
        tree,
        lambda path, pd: rules.pspec_checked(pd.shape, pd.axes,
                                             tp_fallback=True))


def abstract_params(tree, dtype, mesh=None, rules=None):
    """PDef tree -> tensors with no data (the dry-run's input): meta
    tensors, or on ``mesh`` DTensors laid out by ``spec_tree``'s specs
    whose local shards are meta tensors of the shard's shape."""
    def mk(path, pd):
        dt = pd.dtype or dtype
        spec = None if mesh is None else rules.pspec_checked(
            pd.shape, pd.axes, tp_fallback=True)
        return abstract_tensor(pd.shape, dt, mesh, spec)

    return _tree_map(tree, mk)


def from_numpy(tree, dtype=None, device: DeviceLike = None):
    """The JAX package's parameter tree, as numpy arrays
    (``jax.tree.map(np.asarray, params)``), as the port's: the same keys and
    shapes, floating leaves cast to ``dtype`` (kept as they are when None),
    on ``device`` (``"cuda"`` unless named)."""
    dev = resolve(device)

    def leaf(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":       # ml_dtypes: no numpy kind
            t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a))           # a writable copy
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(dev)

    return map_tensors(tree, leaf)


def train_state_from_numpy(state, device: DeviceLike = None):
    """The JAX package's train state as numpy arrays (``{"params", "opt":
    {"mu", "nu", "step"}}``, and ``"ef_error"`` under gradient
    compression) as the port's, on ``device`` (``"cuda"`` unless named):
    the same keys, shapes and dtypes; ``step`` a 0-d int32 tensor."""
    opt = state.get("opt", {})
    missing = sorted({"params", "opt"} - set(state)) + sorted(
        {"mu", "nu", "step"} - set(opt))
    if missing:
        raise ValueError(f"not a train state: it lacks {missing}")
    return from_numpy(state, device=device)


def stack_pdefs(tree, n: int, axis_name: Optional[str] = "layers"):
    """Prepend a stacking dim (one entry a layer) to every leaf."""
    return _tree_map(
        tree,
        lambda path, pd: PDef((n,) + pd.shape, (axis_name,) + pd.axes,
                              pd.init, pd.scale, pd.dtype),
    )


def count_params(tree) -> int:
    total = 0

    def add(path, pd):
        nonlocal total
        n = 1
        for s in pd.shape:
            n *= s
        total += n
        return pd

    _tree_map(tree, add)
    return total


def cast_tree(params, dtype):
    return map_tensors(
        params, lambda x: x.to(dtype) if x.is_floating_point() else x)

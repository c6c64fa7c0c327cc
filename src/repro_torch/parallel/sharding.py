"""Logical-axis sharding rules and activation constraints.

Model code names axes logically (``shard(x, "batch", "seq_shard", None)``);
rules bound to the active mesh resolve logical names to mesh axes.  Outside a
sharding context (one device, the CPU tests) everything is a no-op, so the
same model code runs everywhere.

The rule tables are the JAX package's, letter for letter (its DESIGN.md §5):
  * TP  : heads / ff / vocab / experts  -> 'model'
  * DP  : batch                         -> ('pod', 'data')   (pod folded into DP)
  * SP  : residual-stream seq           -> 'model' (Megatron sequence parallelism)
  * EP  : expert dim                    -> 'model'
  * decode: KV-cache length             -> 'model' (avoids kv-head padding)

PyTorch has no SPMD compiler.  A mesh here is a
``torch.distributed.device_mesh.DeviceMesh`` and a sharded tensor a
``DTensor``: a ``PartitionSpec`` becomes DTensor placements
(``spec_placements``), and ``shard`` redistributes a DTensor to the
placements of its logical axes, the counterpart of
``with_sharding_constraint``.  DTensor's sharding propagation then plays
GSPMD's part: it picks each op's layout and issues the collectives.
Inside ``use_sharding`` with a mesh, plain tensors that meet a DTensor
count as replicated (``implicit_replication``), as constants do under GSPMD.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple, Union

import torch

AxisVal = Union[None, str, Tuple[str, ...]]

TRAIN_RULES: Dict[str, AxisVal] = {
    # weights
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "ff": "model",
    "vocab": "model",
    "experts": "model",
    "ssm_heads": "model",
    "ssm_state": None,
    "ssm_inner": "model",
    "layers": None,
    # activations
    "batch": ("pod", "data"),
    "seq": None,
    "seq_shard": "model",       # sequence-parallel residual stream
    "act_heads": "model",
    "act_kv_heads": "model",
    "act_ff": "model",
    "act_experts": "model",
    "act_ssm_heads": "model",
    "act_ssm_inner": "model",
    "expert_cap": None,
    "cache_seq": "model",       # decode KV cache shards length, not kv-heads
    # misc
    "stage": "pod",             # pipeline-parallel stage placement (optional path)
    "opt_shard": ("pod", "data"),  # ZeRO-1 optimizer-state sharding axes
    "fsdp": ("pod", "data"),    # ZeRO-3 secondary weight sharding axes
}

# Prefill: like training (seq-parallel residual), cache written length-sharded.
PREFILL_RULES = dict(TRAIN_RULES)

# Decode: length-1 activations replicate head/seq axes; weights stay TP-sharded;
# the model axis works on KV-cache length shards instead.
DECODE_RULES = dict(TRAIN_RULES)
DECODE_RULES.update({
    "seq_shard": None,
    "act_heads": None,
    "act_kv_heads": None,
    # Serving weights stay 2D-sharded (model × data): a 72B/108B bf16
    # checkpoint at TP=16 alone is 13.5 GB a device, over budget with the
    # KV cache, so the data axis carries weight shards too.
    "fsdp": "data",
})

# Pure-FSDP (ZeRO-3) training layout: no tensor parallelism — batch shards
# over every axis, weights/optimizer shard over every axis, per-layer weight
# all-gathers replace the Megatron activation collectives.
FSDP_RULES: Dict[str, AxisVal] = {k: None for k in TRAIN_RULES}
FSDP_RULES.update({
    "batch": ("data", "model"),
    "stage": "pod",
    "opt_shard": ("pod", "data", "model"),
    "fsdp": ("pod", "data", "model"),
})

# long_500k (global_batch=1): nothing to data-shard, so context-parallelize the
# KV cache over BOTH data and model axes (2048 positions/device at 512k×256).
LONG_DECODE_RULES = dict(DECODE_RULES)
LONG_DECODE_RULES.update({
    "batch": None,
    "cache_seq": ("data", "model"),
})


class PartitionSpec(tuple):
    """One entry a tensor dimension: None (replicated), a mesh axis, or a
    tuple of mesh axes (``jax.sharding.PartitionSpec``'s counterpart; as
    there, a tuple of one axis is that axis)."""

    def __new__(cls, *parts: AxisVal):
        return super().__new__(cls, (
            p[0] if isinstance(p, tuple) and len(p) == 1 else p
            for p in parts))

    def __reduce__(self):
        return (PartitionSpec, tuple(self))

    def __repr__(self) -> str:
        return "PartitionSpec(" + ", ".join(map(repr, self)) + ")"


P = PartitionSpec


def mesh_axes(mesh) -> Dict[str, int]:
    """Axis name -> size, in axis order, of a ``DeviceMesh`` or of a
    ``launch.mesh.Mesh``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return {n: int(s) for n, s in zip(names, mesh.shape)}
    return {n: int(s) for n, s in zip(mesh.axis_names, mesh.devices.shape)}


@dataclass(frozen=True)
class Rules:
    table: Dict[str, AxisVal]
    mesh_axes: Tuple[str, ...]
    mesh_shape: Dict[str, int] = field(default_factory=dict)

    def resolve(self, logical: Optional[str]) -> AxisVal:
        if logical is None:
            return None
        if logical not in self.table:
            raise KeyError(f"unknown logical axis {logical!r}")
        v = self.table[logical]
        if v is None:
            return None
        if isinstance(v, str):
            return v if v in self.mesh_axes else None
        kept = tuple(a for a in v if a in self.mesh_axes)
        return kept if kept else None

    def axis_size(self, v: AxisVal) -> int:
        if v is None:
            return 1
        if isinstance(v, str):
            v = (v,)
        n = 1
        for a in v:
            n *= self.mesh_shape.get(a, 1)
        return n

    def pspec(self, *axes: Optional[str]) -> PartitionSpec:
        return P(*[self.resolve(a) for a in axes])

    def pspec_checked(self, shape: Tuple[int, ...],
                      axes: Tuple[Optional[str], ...],
                      tp_fallback: bool = False) -> PartitionSpec:
        """Resolve axes, dropping assignments that do not divide the dim.

        ``tp_fallback`` (weights only):
          (a) if nothing landed on 'model' and the tensor is large, place
              'model' on the largest divisible free dim — row-parallel
              fallback for head counts that don't divide TP (llama4: 40
              heads on model=16 -> shard d_model instead);
          (b) FSDP/ZeRO-3: additionally shard large weights over the 'fsdp'
              axes ('data') so parameter + optimizer memory scales with the
              full device count.
        """
        parts = []
        used = set()
        for dim, ax in zip(shape, axes):
            r = self.resolve(ax)
            names = (r,) if isinstance(r, str) else (r or ())
            if r is not None and dim % self.axis_size(r) == 0 and \
                    not (set(names) & used):
                parts.append(r)
                used.update(names)
            else:
                parts.append(None)
        numel = 1
        for d in shape:
            numel *= d
        tp_mode = self.table.get("heads") is not None
        if tp_fallback and tp_mode and "model" in self.mesh_shape and \
                "model" not in used and numel >= (1 << 20):
            cands = [(d, i) for i, (d, pspec_e) in
                     enumerate(zip(shape, parts)) if pspec_e is None and
                     d % self.mesh_shape["model"] == 0 and d > 1]
            if cands:
                _, i = max(cands)
                parts[i] = "model"
                used.add("model")
        fsdp = self.resolve("fsdp") if tp_fallback and \
            "fsdp" in self.table else None
        if fsdp is not None and numel >= (1 << 21):
            fnames = set((fsdp,) if isinstance(fsdp, str) else fsdp)
            if not (fnames & used):
                n = self.axis_size(fsdp)
                cands = [(d, i) for i, (d, pspec_e) in
                         enumerate(zip(shape, parts))
                         if pspec_e is None and d % n == 0 and d >= n]
                if cands:
                    _, i = max(cands)
                    parts[i] = fsdp
        return P(*parts)


def spec_placements(spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: for each mesh dimension,
    ``Shard(i)`` where the spec's entry for tensor dimension ``i`` names
    that mesh axis, else ``Replicate()``.  A tuple of axes shards one
    tensor dimension over several mesh dimensions, in mesh order.  A mesh
    axis of size 1 splits nothing: it is ``Replicate()`` whatever the
    spec says."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for i, name in enumerate(mesh.mesh_dim_names):
        dim = None
        if mesh.size(i) == 1:
            out.append(Replicate())
            continue
        for d, e in enumerate(spec):
            if e == name or (isinstance(e, tuple) and name in e):
                dim = d
                break
        out.append(Replicate() if dim is None else Shard(dim))
    return tuple(out)


def shard_shape(shape, spec, mesh) -> Tuple[int, ...]:
    """The local shape of a tensor of ``shape`` laid out by ``spec`` on
    ``mesh`` (``NamedSharding.shard_shape``): each dimension divided by
    the sizes of the mesh axes its entry names."""
    sizes = mesh_axes(mesh)
    out = []
    for i, d in enumerate(shape):
        e = spec[i] if i < len(spec) else None
        names = (e,) if isinstance(e, str) else (e or ())
        n = 1
        for a in names:
            n *= sizes[a]
        if d % n:
            raise ValueError(f"dim {i} of {tuple(shape)} does not divide "
                             f"over {names}")
        out.append(d // n)
    return tuple(out)


def abstract_tensor(shape, dtype, mesh=None, spec=None):
    """A tensor with no data: a meta tensor of ``shape``, or, on a mesh, a
    DTensor laid out by ``spec`` whose local shard is a meta tensor of the
    shard's shape (the dry-run's ``ShapeDtypeStruct``)."""
    if mesh is None:
        return torch.empty(tuple(shape), dtype=dtype, device="meta")
    from torch.distributed.tensor import DTensor
    local = torch.empty(shard_shape(shape, spec, mesh), dtype=dtype,
                        device="meta")
    stride = []
    acc = 1
    for d in reversed(tuple(shape)):
        stride.append(acc)
        acc *= d
    return DTensor.from_local(local, mesh, spec_placements(spec, mesh),
                              run_check=False, shape=tuple(shape),
                              stride=tuple(reversed(stride)))


def is_dtensor(x) -> bool:
    if type(x) is torch.Tensor:     # the plain path's case, with no import
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def local(x):
    """The local shard of a DTensor; any other tensor itself."""
    return x.to_local() if is_dtensor(x) else x


def local_shard(x):
    """(local shard, global index of its first element) of a DTensor; a
    plain tensor is its own shard, at index 0 in every dim."""
    if not is_dtensor(x):
        return x, (0,) * x.dim()
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    _, offset = compute_local_shape_and_global_offset(
        x.shape, x.device_mesh, x.placements)
    return x.to_local(), tuple(offset)


def _along(x, dims):
    """``x``'s placements with its shards of tensor ``dims`` kept and
    every other mesh dim replicated."""
    from torch.distributed.tensor import Replicate
    return tuple(p if p.is_shard() and p.dim in dims else Replicate()
                 for p in x.placements)


def local_like(t, x, dims):
    """The local shard of ``t`` laid out as ``x`` is along tensor ``dims``
    and replicated along the others (a collective where it was not);
    ``t`` itself where it is not a DTensor."""
    if not is_dtensor(t):
        return t
    place = _along(x, dims)
    if tuple(t.placements) != place:
        t = t.redistribute(x.device_mesh, place)
    return t.to_local()


def unsharded(x, dims):
    """A DTensor ``x`` gathered along tensor ``dims``: its shards of those
    dims replaced by replicas (an all-gather where it had any).  Any other
    tensor is returned as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    dims = set(dims)
    want = tuple(Replicate() if p.is_shard() and p.dim in dims else p
                 for p in x.placements)
    if want == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def merge_ready(x, start: int, end: int):
    """``x`` ready for a reshape that merges its dims ``start`` .. ``end -
    1``: gathered along those dims but the first (``unsharded``).  For a
    weight, the gather an FSDP layer makes; for an activation [B, S, D]
    before a product with a weight (which flattens its leading dims), the
    sequence all-gather of Megatron sequence parallelism.  DTensor would
    otherwise make a strided shard of the merged dim, whose redistribution
    gathers far more than the tensor's bytes, or refuse the reshape."""
    return unsharded(x, range(start + 1, end))


class _GatheredGrad(torch.autograd.Function):
    """Identity whose backward gathers the gradient along the dims between
    the first and the last (``merge_ready``)."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return merge_ready(g, 0, g.dim() - 1)


def seq_product(x, w):
    """``x @ w`` for an activation ``x`` [B, S, .., K] and a weight ``w``
    [K, N], its leading dims flattened into one product (as ``matmul``
    folds them on a contiguous ``x``; on a strided DTensor it would
    broadcast ``w`` over them instead).  On DTensors, Megatron sequence
    parallelism's layout: ``x`` is gathered along its sequence
    (``merge_ready``) before the product, and the product's gradient
    likewise in the backward, so that the product flattens only
    batch-sharded leading dims."""
    sharded = is_dtensor(x)
    x = merge_ready(x, 0, x.dim() - 1)
    y = (x.flatten(0, -2) @ w).unflatten(0, x.shape[:-1])
    return _GatheredGrad.apply(y) if sharded else y


def shard_local(fn, x, *others, dims: Tuple[int, ...], whole=()):
    """``fn(x, *others, *whole)`` run on each device's shards, where the
    function is independent along ``dims`` (batch and heads of an
    attention, the rows of a routing): ``x`` and the DTensors of
    ``others`` are laid out as ``x`` is along those dims and replicated
    along the others, those of ``whole`` replicated (``local_like``:
    a collective where they were not), ``fn`` runs on their local shards
    with no DTensor in sight, and each tensor of its result (a tensor or
    nested tuples of them) is laid out as ``x``'s shards were.  Plain
    tensors go to ``fn`` as they are."""
    if not is_dtensor(x):
        return fn(x, *others, *whole)
    from torch.distributed.tensor import DTensor
    mesh, place = x.device_mesh, _along(x, dims)
    out = fn(*(local_like(t, x, dims) for t in (x, *others)),
             *(local_like(t, x, ()) for t in whole))

    def wrap(t):
        if isinstance(t, (tuple, list)):
            return type(t)(wrap(u) for u in t)
        return DTensor.from_local(t, mesh, place, run_check=False)
    return wrap(out)


def fsdp_gathered(weights, x):
    """``weights`` (a tensor or a dict of them) as a step over ``x`` uses
    them: where ``x`` holds more than one position a row (training,
    prefill), each DTensor is gathered along the mesh axes of the rule
    table's ``fsdp`` entry, the per-layer all-gather that GSPMD makes
    inside the JAX package's layer scan (ZeRO-3); a one-position step
    (decode) leaves the layout to DTensor, which moves the activations.
    Outside a sharding context, or on plain tensors, ``weights`` as they
    are."""
    ctx = current_ctx()
    if ctx is None or x.dim() < 2 or x.shape[1] <= 1:
        return weights
    axes = ctx.rules.resolve("fsdp")
    names = {axes} if isinstance(axes, str) else set(axes or ())
    from torch.distributed.tensor import Replicate

    def one(w):
        if isinstance(w, dict):
            return {k: one(v) for k, v in w.items()}
        if not is_dtensor(w):
            return w
        want = tuple(
            Replicate() if p.is_shard() and n in names else p
            for n, p in zip(w.device_mesh.mesh_dim_names, w.placements))
        if want == tuple(w.placements):
            return w
        return w.redistribute(w.device_mesh, want)
    return one(weights)


def first_argmax(x, row_max=None):
    """The index of the first maximum along the last dim (``jnp.argmax``'s
    choice on ties), as int32, spelled as a max, a mask and a min, so that
    on a DTensor sharded along that dim each reduces its [..] statistics
    across the shards, where DTensor's ``argmax`` would gather ``x``.
    ``row_max``: ``x``'s maxima over the last dim, kept, when known."""
    x = x.detach()
    if row_max is None:
        row_max = x.amax(dim=-1, keepdim=True)
    n = x.shape[-1]
    idx = torch.arange(n, dtype=torch.int32, device=x.device)
    return torch.where(x == row_max, idx, n).amin(dim=-1)


def match_placements(x, like):
    """``x`` laid out as ``like`` when both are DTensors (a collective
    where the layouts differ); ``x`` itself otherwise."""
    if not (is_dtensor(x) and is_dtensor(like)) or \
            x.placements == like.placements:
        return x
    return x.redistribute(like.device_mesh, like.placements)


@dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec on it (``jax.sharding.NamedSharding``)."""
    mesh: object
    spec: PartitionSpec


@dataclass
class ShardingCtx:
    mesh: object
    rules: Rules


_STATE = threading.local()


def current_ctx() -> Optional[ShardingCtx]:
    return getattr(_STATE, "ctx", None)


@contextlib.contextmanager
def use_sharding(mesh, table: Dict[str, AxisVal]):
    """Bind ``table`` to ``mesh`` for the ``shard`` calls inside; with a
    mesh, plain tensors that meet DTensors count as replicated."""
    prev = current_ctx()
    if mesh is None:
        _STATE.ctx = None
        replication = contextlib.nullcontext()
    else:
        from torch.distributed.tensor.experimental import \
            implicit_replication
        _STATE.ctx = ShardingCtx(mesh, _bind(mesh, table))
        replication = implicit_replication()
    try:
        with replication:
            yield _STATE.ctx
    finally:
        _STATE.ctx = prev


def _bind(mesh, table: Dict[str, AxisVal]) -> Rules:
    shape = mesh_axes(mesh)
    return Rules(table, tuple(shape), shape)


def make_rules(mesh, table: Dict[str, AxisVal]) -> Optional[Rules]:
    if mesh is None:
        return None
    return _bind(mesh, table)


def shard(x, *axes: Optional[str]):
    """Constrain activation ``x`` to logical axes (no-op w/o a sharding ctx):
    a DTensor is redistributed to the axes' placements, a plain tensor
    (the whole value) becomes a DTensor with them."""
    ctx = current_ctx()
    if ctx is None:
        return x
    if x.dim() != len(axes):
        raise ValueError(f"rank mismatch: {tuple(x.shape)} vs axes {axes}")
    spec = ctx.rules.pspec_checked(tuple(x.shape), axes)
    placements = spec_placements(spec, ctx.mesh)
    if is_dtensor(x):
        if tuple(x.placements) == placements:
            return x
        return x.redistribute(ctx.mesh, placements)
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(x, ctx.mesh, placements, src_data_rank=None)


def named_sharding(*axes: Optional[str]) -> Optional[NamedSharding]:
    ctx = current_ctx()
    if ctx is None:
        return None
    return NamedSharding(ctx.mesh, ctx.rules.pspec(*axes))


def batch_axis_size(mesh, table=TRAIN_RULES) -> int:
    """Total data-parallel degree of the mesh (pod × data)."""
    if mesh is None:
        return 1
    rules = _bind(mesh, table)
    v = rules.resolve("batch")
    if v is None:
        return 1
    if isinstance(v, str):
        v = (v,)
    n = 1
    for a in v:
        n *= rules.mesh_shape[a]
    return n

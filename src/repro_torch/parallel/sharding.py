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
from typing import Dict, NamedTuple, Optional, Tuple, Union

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


def whole(x):
    """The whole value of a DTensor on every rank (a collective where it
    is sharded); any other tensor itself."""
    return x.full_tensor() if is_dtensor(x) else x


def distribute(x, mesh, spec):
    """``x``, the whole tensor on every rank, laid out on ``mesh`` by
    ``spec`` as a DTensor: each rank keeps its own shard, with no
    collective (``jax.device_put`` to a ``NamedSharding``).  A shard is a
    copy where it would be a view of ``x``, so that dropping ``x`` frees
    the whole."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    placements = spec_placements(spec, mesh)
    d = distribute_tensor(x, mesh, placements, src_data_rank=None)
    shard = d.to_local()
    if shard.untyped_storage().nbytes() == \
            shard.numel() * shard.element_size() or \
            all(p.is_replicate() for p in placements):
        return d
    return DTensor.from_local(shard.clone(), mesh, placements,
                              run_check=False, shape=d.shape,
                              stride=d.stride())


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


def local_span(x, dims, dim: int) -> Tuple[int, int]:
    """(global index of the first, count) of this device's elements of
    ``x``'s dim ``dim`` once ``x`` is laid out along ``dims`` as
    ``shard_local`` lays it; of a plain tensor, (0, its size)."""
    if not is_dtensor(x):
        return 0, x.shape[dim]
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    shape, offset = compute_local_shape_and_global_offset(
        x.shape, x.device_mesh, _along(x.placements, dims))
    return offset[dim], shape[dim]


def _along(placements, dims, to=None):
    """A DTensor's ``placements`` with its shards of tensor ``dims`` kept
    and every other mesh dim replicated; with ``to``, each shard of
    ``dims[i]`` moved to tensor dim ``to[i]`` (replicated where that is
    None)."""
    from torch.distributed.tensor import Replicate, Shard
    if to is None:
        return tuple(p if p.is_shard() and p.dim in dims else Replicate()
                     for p in placements)
    out = []
    for p in placements:
        d = to[dims.index(p.dim)] if p.is_shard() and p.dim in dims \
            else None
        out.append(Replicate() if d is None else Shard(d))
    return tuple(out)


class Along(NamedTuple):
    """A tensor beside ``shard_local``'s ``x`` whose dims ``dims`` stand
    where ``x``'s ``dims`` do, position by position (None: replicated
    there): decay rates [H] beside ``x`` [B, S, H, P] run along (0, 2) are
    ``Along(A, (None, 0))``, a state [B, H, P, N] ``Along(s, (0, 1))``."""
    tensor: torch.Tensor
    dims: Tuple[Optional[int], ...]


def local_like(t, x, dims, to=None):
    """The local shard of ``t`` laid out as ``x`` is along tensor ``dims``
    and replicated along the others (a collective where it was not); with
    ``to``, ``x``'s shards of ``dims[i]`` fall on ``t``'s dim ``to[i]``
    (``Along``), and where ``t`` is then replicated along a mesh dim that
    splits ``x``, each device reads it for its own shard of ``x``, so its
    gradient there is a partial sum.  A plain ``t`` beside a DTensor ``x``
    is the whole value, replicated (as under ``use_sharding``), so it is
    cut to the same shard with no collective; beside a plain ``x``, ``t``
    itself."""
    if not is_dtensor(t):
        if not is_dtensor(x):
            return t
        from torch.distributed.tensor import DTensor, Replicate
        t = DTensor.from_local(t, x.device_mesh,
                               (Replicate(),) * x.device_mesh.ndim,
                               run_check=False)
    place = _along(x.placements, dims, to)
    if tuple(t.placements) != place:
        t = t.redistribute(x.device_mesh, place)
    if to is None:
        return t.to_local()
    from torch.distributed.tensor import Partial
    grad = tuple(Partial() if q.is_replicate() and p.is_shard() else q
                 for p, q in zip(_along(x.placements, dims), place))
    if grad == place:
        return t.to_local()
    return _LaidGrad.apply(t).to_local(grad_placements=grad)


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


def _uneven(x, dim: int) -> bool:
    """Whether DTensor ``x`` splits its dim ``dim`` over more shards than
    divide it (Hymba's 5 KV heads over a mesh axis of 2)."""
    n = 1
    for i, p in enumerate(x.placements):
        if p.is_shard(dim):
            n *= x.device_mesh.size(i)
    return x.shape[dim] % n != 0


def merge_ready(x, start: int, end: int):
    """``x`` ready for a reshape that merges its dims ``start`` .. ``end -
    1``: gathered along those dims but the first (``unsharded``), and
    along the first too where it is split unevenly, which DTensor cannot
    flatten (GSPMD pads such a shard; the gather keeps the values exact).
    For a weight, the gather an FSDP layer makes; for an activation [B, S,
    D] before a product with a weight (which flattens its leading dims),
    the sequence all-gather of Megatron sequence parallelism.  DTensor
    would otherwise make a strided shard of the merged dim, whose
    redistribution gathers far more than the tensor's bytes, or refuse
    the reshape."""
    first = start if is_dtensor(x) and _uneven(x, start) else start + 1
    return unsharded(x, range(first, end))


class _GatheredGrad(torch.autograd.Function):
    """Identity whose backward gathers the gradient along the dims between
    the first and the last (``merge_ready``)."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return merge_ready(g, 0, g.dim() - 1)


class _LaidGrad(torch.autograd.Function):
    """Identity on a DTensor whose backward lays the gradient out as the
    DTensor is (``grad_like``), but along the mesh dims where the DTensor
    holds partial sums, which a gradient cannot take: partial sums of the
    gradient are summed into that layout (``local_like``'s ``Along``
    tensors: at the tensor's size where it leaves ``shard_local``, not
    carried on into the ops that made it and reduced at theirs)."""

    @staticmethod
    def forward(ctx, t):
        ctx.placements = t.placements
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        want = tuple(q if f.is_partial() else f
                     for f, q in zip(ctx.placements, g.placements))
        if tuple(g.placements) == want:
            return g
        return g.redistribute(g.device_mesh, want)


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose backward makes the gradient contiguous: a local
    shard's gradient (``shard_local``) goes back into a DTensor, whose
    views of it need strides a permuted product's gradient lacks."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def grad_like(t):
    """``t`` whose gradient is laid out as ``t`` is, as GSPMD gives a
    cotangent its primal's sharding.  DTensor's op rules choose the
    layouts of a backward by their wire bytes alone: one that comes back
    sharded along another dim can leave the next product of the backward
    counted whole on every device.  Any other tensor is returned as it
    is."""
    return _LaidGrad.apply(t) if is_dtensor(t) else t


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


def shard_local(fn, x, *others, dims: Tuple[int, ...]):
    """``fn(x, *others)`` run on each device's shards, where the function
    is independent along ``dims`` (batch and heads of an attention, the
    rows of a routing): ``x`` and the DTensors of ``others`` are laid out
    as ``x`` is along those dims (an ``Along`` of ``others`` along its own
    dims: a weight read whole by every row is ``Along(w, (None,) *
    len(dims))``, its gradient summed over the devices that split ``x``)
    and replicated along the others (``local_like``: a collective where
    they were not), ``fn`` runs on their local shards with no DTensor in
    sight, and each tensor of its result (a tensor, an ``Along``, or
    nested tuples of them) is laid out as ``x``'s shards were (an
    ``Along``'s along its dims).  Plain tensors go to ``fn`` as they
    are, and an ``Along`` as its tensor."""
    if not is_dtensor(x):
        return _unwrapped(fn(x, *_unwrapped(others)))
    laid = [_ContiguousGrad.apply(local_like(t.tensor, x, dims, t.dims)
                                  if isinstance(t, Along) else
                                  local_like(t, x, dims))
            for t in (x, *others)]
    return _wrapped(fn(*laid), x.device_mesh, tuple(x.placements), dims)


def _wrapped(t, mesh, placements, dims):
    """``shard_local``'s result ``t`` as DTensors laid out along ``dims``
    as ``placements`` are (an ``Along`` along its own dims).  A function
    of the module, not a closure: a nested function that calls itself
    holds its frame's tensors until the collector finds the cycle, which
    the dry-run's peak of live bytes would count."""
    from torch.distributed.tensor import DTensor
    if isinstance(t, Along):
        return DTensor.from_local(t.tensor, mesh,
                                  _along(placements, dims, t.dims),
                                  run_check=False)
    if isinstance(t, (tuple, list)):
        return type(t)(_wrapped(u, mesh, placements, dims) for u in t)
    return DTensor.from_local(t, mesh, _along(placements, dims),
                              run_check=False)


def _unwrapped(t):
    """``t`` with each ``Along`` in it (nested tuples) its tensor."""
    if isinstance(t, Along):
        return t.tensor
    if isinstance(t, (tuple, list)):
        return type(t)(_unwrapped(u) for u in t)
    return t


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


def batch_laid(inputs):
    """A step's inputs (a tensor or a dict of them) laid out along their
    batch by the rules' ``batch`` axes and replicated along the rest, as
    the dry-run's input specs lay them out (``launch/specs.py``): dim 0,
    or dim 1 of M-RoPE's [3, B, S] ``positions``.  Each rank holds the
    whole of a plain tensor (the JAX package's uncommitted input to a
    jitted step) and keeps its own rows, with no collective.  From a
    replicated batch, DTensor would scatter the vocab-sharded embedding's
    masked partial sums over the batch with the whole batch's mask, which
    fails.  DTensors, scalars, and every input outside a sharding context
    are returned as they are."""
    ctx = current_ctx()
    if ctx is None:
        return inputs

    def one(x, key=None):
        if isinstance(x, dict):
            return {k: one(v, k) for k, v in x.items()}
        if not isinstance(x, torch.Tensor) or is_dtensor(x) or x.dim() == 0:
            return x
        lead = (None, "batch") if key == "positions" and x.dim() == 3 \
            else ("batch",)
        axes = lead + (None,) * (x.dim() - len(lead))
        spec = ctx.rules.pspec_checked(tuple(x.shape), axes)
        from torch.distributed.tensor import distribute_tensor
        return distribute_tensor(x, ctx.mesh, spec_placements(spec, ctx.mesh),
                                 src_data_rank=None)
    return one(inputs)


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

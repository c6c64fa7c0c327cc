"""Operator-counting cost model of a PyTorch step: the static watcher.

The counterpart of the JAX package's ``core/hlo_analysis.py``.  There is no
compiled module to walk: PyTorch runs eagerly, so the step is run once
under ``OpCounter``, a ``TorchDispatchMode`` that sees every aten call after
autograd (forward and backward alike, composite operators decomposed) and
classifies it as the walker classifies an HLO instruction:

  * dots         — ``mm``, ``bmm``, ``addmm``, ``baddbmm`` (what ``matmul``,
                   ``einsum`` and ``linear`` decompose into): 2·M·N·K flops
                   (``_dot_flops``); ``dot_bytes`` are their operand and
                   result bytes
  * convolution  — the walker's ``_conv_flops`` rule
  * elementwise and transcendental ops — one flop per output element
                   (transcendentals are counted separately too); the fused
                   aten activations count the element ops XLA lowers them to
  * reductions   — the input's element count
  * views, copies, gathers, scatters — zero flops
  * hbm_bytes    — operand and result bytes of every op that is not a view.
                   Eager mode fuses nothing, so this is an upper bound, as
                   the walker's count of unfused boundaries is
  * collectives  — the functional collectives (``_c10d_functional``) and
                   DTensor's all-to-all, by the walker's ring model
                   (``_collective_wire_bytes``)
  * the flash kernel — ``synapse::flash_attention`` (the custom op of
                   ``repro_torch.kernels.flash_attention``) is charged the
                   matmul flops of the pairs its mask leaves
                   (``ref.flops``) and its q/k/v/out bytes as dot bytes.
                   The walker charges a Pallas ``custom-call`` nothing.

The layer loops of the models are the profiler's clock, as the entry
computation's ``while`` is the walker's: ``open_trip``/``close_trip`` mark
one trip of a loop (a layer, or a pair of layers where the JAX package
scans pairs), identity ``autograd.Function``s whose backward marks the
trip's backward, so a train step's backward falls into per-layer samples
in reverse order.  Between trips, ops add up as ``glue``.  The markers do
nothing when no counter is active.

Runs on any device: on meta tensors nothing launches and nothing is
allocated, and the counts equal those of a run on real tensors.

On DTensors the counter counts the local program, one rank's, as the
walker counts a partitioned module: a call on DTensors is left to the
DTensor (the mode returns ``NotImplemented``), whose local ops on its
shards, and the functional collectives of its redistributions, then reach
the counter.  The calls of DTensor's sharding propagation, which runs an
op once on global-shape ``FakeTensor``s, pass through uncounted and hold
no live bytes.
"""
from __future__ import annotations

import contextlib
import math
import threading
import weakref
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)

from repro_torch.kernels.flash_attention import ref as flash_ref

#: aten ops (an in-place ``_`` dropped) that are one element op of the
#: walker's ``ELEMENTWISE`` set: a flop an output element
_ELEMENTWISE = {
    "add", "sub", "rsub", "mul", "div", "maximum", "minimum", "pow",
    "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
    "logical_and", "logical_or", "logical_xor", "logical_not", "neg", "abs",
    "sign", "sgn", "eq", "ne", "lt", "le", "gt", "ge", "where", "masked_fill",
    "clamp", "clamp_min", "clamp_max", "remainder", "fmod", "atan2",
    "reciprocal", "relu", "threshold_backward", "floor", "ceil", "round",
    "trunc", "square"}
#: ... of its ``TRANSCENDENTAL`` set: a flop and a transcendental
_TRANSCENDENTAL = {"exp", "exp2", "log", "log2", "tanh", "rsqrt", "sqrt",
                   "sin", "cos", "expm1", "log1p", "erf"}

#: fused aten activations and their backward: (flops, transcendentals) an
#: output element, the element ops XLA:CPU lowers the same function to
#: (it expands ``logistic`` into negate, exponential, add and divide)
_FUSED: Dict[str, Tuple[int, int]] = {
    "sigmoid": (4, 1),
    "silu": (5, 1),                  # x * logistic(x)
    "silu_backward": (9, 1),
    "sigmoid_backward": (3, 0),      # g * y * (1 - y)
    "tanh_backward": (3, 0),         # g * (1 - y * y)
    "gelu": (8, 1),                  # the tanh form
    "gelu_backward": (14, 1),
    "softplus": (3, 2),              # log1p(exp(x)), the threshold select
    "softplus_backward": (4, 1),
    "addcmul": (2, 0),
    "addcdiv": (2, 0),
    "lerp": (3, 0),
}

#: reductions: the input's element count; ``mean`` also divides its result
_REDUCE = {"sum", "mean", "amax", "amin", "max", "min", "argmax", "argmin",
           "aminmax", "prod", "any", "all", "logsumexp", "var", "std",
           "var_mean", "std_mean", "norm", "linalg_vector_norm", "cumsum",
           "cumprod", "nansum"}

#: softmax family: (flops, transcendentals) an input element — a max and a
#: sum reduction, the subtraction, the exp and the division
_SOFTMAX = {"_softmax": (5, 1), "_log_softmax": (5, 1),
            "_softmax_backward_data": (4, 0),
            "_log_softmax_backward_data": (4, 1)}

#: dots: base name -> index of the first matrix operand
_DOTS = {"mm": 0, "bmm": 0, "addmm": 1, "baddbmm": 1, "addbmm": 1,
         "dot": 0, "vdot": 0, "mv": 0, "addmv": 1}

#: ops that touch no memory
_NO_BYTES = {"empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided", "detach", "lift_fresh",
             "_local_scalar_dense", "wait_tensor", "_wrap_tensor_autograd"}

#: functional collectives, and DTensor's all-to-all between two sharded
#: dims, -> the walker's collective kinds
_COLLECTIVES = {("_c10d_functional", "all_reduce"): "all-reduce",
                ("_c10d_functional", "all_gather_into_tensor"): "all-gather",
                ("_c10d_functional", "reduce_scatter_tensor"):
                    "reduce-scatter",
                ("_c10d_functional", "all_to_all_single"): "all-to-all",
                ("_dtensor", "shard_dim_alltoall"): "all-to-all"}


_COMPOSITE = torch._C.DispatchKey.CompositeImplicitAutograd

#: tensor subclass -> "dtensor", "fake" or None, read once a class
_SUBCLASS_KIND: Dict[type, Optional[str]] = {torch.Tensor: None}


def _subclass_kind(types) -> Optional[str]:
    """"dtensor" if tensor types hold a DTensor, "fake" if they hold a
    FakeTensor, else None."""
    kind = None
    for t in types:
        k = _SUBCLASS_KIND.get(t, "")
        if k == "":
            from torch._subclasses.fake_tensor import FakeTensor
            from torch.distributed.tensor import DTensor
            k = _SUBCLASS_KIND[t] = "dtensor" if issubclass(t, DTensor) \
                else "fake" if issubclass(t, FakeTensor) else None
        if k == "dtensor":
            return k
        kind = kind or k
    return kind


def _tensors(x, out: list) -> list:
    """The tensors in an op's arguments or result (tensors, and lists and
    tuples of them), appended to ``out``."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _tensors(v, out)
    return out


def _tensor_bytes(t: torch.Tensor) -> float:
    """The bytes of ``t``'s elements (its shape, not its storage)."""
    return float(t.numel() * t.element_size())


@dataclass
class CollectiveOp:
    kind: str
    wire_bytes: float            # per chip, per execution
    group_size: int
    stride: int                  # rank stride within a group
    count: float = 1.0           # executions
    shape: str = ""

    @property
    def total_bytes(self) -> float:
        return self.wire_bytes * self.count


@dataclass
class OpCost:
    """The walker's ``HloCost`` for a PyTorch run, plus ``dot_flops``, the
    share of ``flops`` that dots, convolutions and the flash kernel did."""
    flops: float = 0.0
    transcendentals: float = 0.0
    hbm_bytes: float = 0.0       # upper bound: every op's boundary
    dot_bytes: float = 0.0       # operand+result bytes of dots/convs only
    dot_flops: float = 0.0
    collectives: List[CollectiveOp] = field(default_factory=list)
    op_flops: Dict[str, float] = field(default_factory=dict)   # by aten op

    def scaled(self, k: float) -> "OpCost":
        return OpCost(
            flops=self.flops * k, transcendentals=self.transcendentals * k,
            hbm_bytes=self.hbm_bytes * k, dot_bytes=self.dot_bytes * k,
            dot_flops=self.dot_flops * k,
            collectives=[CollectiveOp(c.kind, c.wire_bytes, c.group_size,
                                      c.stride, c.count * k, c.shape)
                         for c in self.collectives],
            op_flops={n: v * k for n, v in self.op_flops.items()})

    def add(self, other: "OpCost") -> "OpCost":
        of = dict(self.op_flops)
        for n, v in other.op_flops.items():
            of[n] = of.get(n, 0.0) + v
        return OpCost(
            flops=self.flops + other.flops,
            transcendentals=self.transcendentals + other.transcendentals,
            hbm_bytes=self.hbm_bytes + other.hbm_bytes,
            dot_bytes=self.dot_bytes + other.dot_bytes,
            dot_flops=self.dot_flops + other.dot_flops,
            collectives=self.collectives + other.collectives,
            op_flops=of)

    def collective_bytes(self) -> Dict[str, float]:
        out: Dict[str, float] = defaultdict(float)
        for c in self.collectives:
            out[c.kind] += c.total_bytes
        return dict(out)

    @property
    def collective_total(self) -> float:
        return sum(c.total_bytes for c in self.collectives)

    def empty(self) -> bool:
        return not (self.flops or self.hbm_bytes or self.collectives)


def _collective_wire_bytes(kind: str, out_bytes: float, n: int) -> float:
    """The walker's ring model: wire bytes a chip sends for one collective
    whose result holds ``out_bytes``, over a group of ``n``."""
    if n <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * out_bytes * (n - 1) / n
    if kind == "all-gather":
        return out_bytes * (n - 1) / n
    if kind == "reduce-scatter":
        return out_bytes * (n - 1)
    if kind == "all-to-all":
        return out_bytes * (n - 1) / n
    if kind == "collective-permute":
        return out_bytes
    return out_bytes


def _conv_flops(out_numel: float, weight_shape) -> float:
    """The walker's rule: 2 · out_numel · the weight's elements but its
    output features (an approximation there, where it takes the last dim
    of XLA's kernel layout for them).  PyTorch's weights are
    ``[out, in/groups, *kernel]``, so the output features are dim 0 and
    the rule counts the multiply-adds of an output element exactly."""
    return 2.0 * out_numel * math.prod(weight_shape[1:])


def _group_of(group_name: str) -> Tuple[int, int]:
    """(size, rank stride) of a functional collective's process group."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    pg = _resolve_process_group(group_name)
    ranks = dist.get_process_group_ranks(pg)
    stride = ranks[1] - ranks[0] if len(ranks) > 1 else 1
    return len(ranks), stride


class _OpInfo:
    """What the counter needs of an op, read once an op overload."""

    __slots__ = ("name", "namespace", "base", "key", "is_view", "composite")

    def __init__(self, func):
        name = func.overloadpacket.__name__
        self.name = str(func)
        self.namespace = func.namespace
        # an in-place op counts as its out-of-place form
        self.base = name[:-1] if name.endswith("_") and \
            not name.startswith("_") else name
        self.key = f"{func.namespace}.{name}"
        self.is_view = func.is_view
        self.composite = torch._C._dispatch_has_kernel_for_dispatch_key(
            func.name(), _COMPOSITE)


class OpCounter(TorchDispatchMode):
    """Counts the aten calls of what runs under it (``with OpCounter() as
    c:``) into ordered runs ``[(label, OpCost)]``: ``"glue"`` between the
    layer loops' trips, ``"scan:<loop>"`` for a trip, ``"scan:<loop>.grad"``
    for its backward.  ``peak_live_bytes`` is the high-water mark of the
    bytes the run allocated and still held (outputs included)."""

    def __init__(self):
        super().__init__()
        self.runs: List[Tuple[str, OpCost]] = []
        self._cur = OpCost()
        self._label = "glue"
        self._depth = 0
        self._lock = threading.RLock()
        self._live: Dict[int, float] = {}
        self._ops: Dict[Any, _OpInfo] = {}
        self.live_bytes = 0.0
        self.peak_live_bytes = 0.0
        #: aten ops counted as data movement only, for a reader to check
        self.unclassified: Dict[str, int] = defaultdict(int)
        #: how many times an op counts (``identical_trips``)
        self._weight = 1.0

    # -- the clock ------------------------------------------------------------

    def enter(self, label: str) -> None:
        """A trip of a loop starts: the next run is ``label``'s.  A loop
        inside a trip (Mamba-2's chunk loop inside a layer) belongs to the
        trip, as a ``while`` nested in a scan's body does in the walker;
        one outside any trip samples on its own."""
        with self._lock:
            self._depth += 1
            if self._depth == 1:
                self._flush(label)

    def leave(self) -> None:
        """The trip ``enter`` started ends; glue follows."""
        with self._lock:
            self._depth -= 1
            if self._depth == 0:
                self._flush("glue")

    def _flush(self, next_label: str) -> None:
        """End the current run: a trip is kept even if it did nothing, glue
        only if it did something."""
        if self._label != "glue" or not self._cur.empty():
            self.runs.append((self._label, self._cur))
        self._cur = OpCost()
        self._label = next_label

    def finish(self) -> List[Tuple[str, OpCost]]:
        """Close the last run; returns every run."""
        with self._lock:
            self._flush("glue")
        return self.runs

    @property
    def total(self) -> OpCost:
        out = OpCost()
        for _, c in self.runs + [("", self._cur)]:
            out = out.add(c)
        return out

    # -- dispatch -------------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        sub = _subclass_kind(types)
        if sub == "dtensor":            # its shards' ops come back here
            return NotImplemented
        if sub == "fake":               # sharding propagation: not run
            return func(*args, **kwargs)
        op = self._ops.get(func)
        if op is None:
            op = self._ops[func] = _OpInfo(func)
        # a composite op reaches the mode whole where autograd is off
        # (inference mode): count the ops it decomposes into, as with
        # autograd on, so ``matmul`` is its ``mm`` or ``bmm``
        if op.composite:
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if not op.is_view:              # a view allocates and moves nothing
            self._count(op, args, kwargs, out)
        return out

    def _count(self, op: "_OpInfo", args, kwargs, out) -> None:
        ns, base = op.namespace, op.base
        outs = _tensors(out, [])
        if _subclass_kind(type(t) for t in outs) == "fake":
            return                      # a factory of sharding propagation
        ins = _tensors(args, [])
        if kwargs:
            _tensors(tuple(kwargs.values()), ins)
        self._track(ins, outs)
        if base in _NO_BYTES:
            return
        in_b = sum(_tensor_bytes(t) for t in ins)
        out_b = sum(_tensor_bytes(t) for t in outs)
        out_n = float(sum(t.numel() for t in outs))
        flops = trans = dot_b = dot_f = 0.0
        coll = None
        if ns == "synapse" and base == "flash_attention":
            q, k = args[0], args[1]
            dot_f = flops = flash_ref.flops(
                q.shape[0], q.shape[1], k.shape[1], q.shape[2],
                causal=args[3], window=args[4])
            dot_b = in_b + out_b
        elif (ns, base) in _COLLECTIVES:
            kind = _COLLECTIVES[ns, base]
            size, stride = _group_of(args[-1])
            coll = CollectiveOp(kind, _collective_wire_bytes(kind, out_b,
                                                             size),
                                size, stride, 1.0,
                                str(tuple(outs[0].shape)))
            in_b = out_b = 0.0          # wire bytes, not device bytes
        elif base in _DOTS:
            a = args[_DOTS[base]]
            dot_f = flops = 2.0 * out_n * (a.shape[-1] if a.dim() else 1)
            mats = args[_DOTS[base]:_DOTS[base] + 2]
            dot_b = sum(_tensor_bytes(t) for t in mats) + out_b
            if _DOTS[base] and args[0] is not None and \
                    kwargs.get("beta", 1) != 0:
                flops += out_n          # the bias add
        elif base == "convolution":
            dot_f = flops = _conv_flops(out_n, args[1].shape)
            dot_b = in_b + out_b
        elif base == "convolution_backward":
            grad_out, weight, mask = args[0], args[2], args[-1]
            dot_f = flops = _conv_flops(float(grad_out.numel()),
                                        weight.shape) * sum(mask[:2])
            dot_b = in_b + out_b
        elif base in _ELEMENTWISE:
            flops = out_n
        elif base in _TRANSCENDENTAL:
            flops = trans = out_n
        elif base in _FUSED:
            f, t = _FUSED[base]
            flops, trans = f * out_n, t * out_n
        elif base in _SOFTMAX:
            f, t = _SOFTMAX[base]
            n_in = float(ins[0].numel())
            flops, trans = f * n_in, t * n_in
        elif base in _REDUCE:
            flops = float(ins[0].numel()) if ins else 0.0
            if base == "mean":
                flops += out_n
        else:
            self.unclassified[op.name] += 1
        w = self._weight
        with self._lock:
            c = self._cur
            c.flops += w * flops
            c.transcendentals += w * trans
            c.hbm_bytes += w * (in_b + out_b)
            c.dot_bytes += w * dot_b
            c.dot_flops += w * dot_f
            if coll is not None:
                coll.count = w
                c.collectives.append(coll)
            if flops:
                c.op_flops[op.key] = c.op_flops.get(op.key, 0.0) + w * flops

    # -- live bytes -----------------------------------------------------------

    def _track(self, ins, outs) -> None:
        """Count each output storage that no input shares as allocated
        until it is freed."""
        seen = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in seen or key in self._live:
                continue
            seen.add(key)
            nbytes = float(st.nbytes())
            with self._lock:
                self._live[key] = nbytes
                self.live_bytes += nbytes
                self.peak_live_bytes = max(self.peak_live_bytes,
                                           self.live_bytes)
            weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        with self._lock:
            self.live_bytes -= self._live.pop(key, 0.0)


def active_counter() -> Optional[OpCounter]:
    """The ``OpCounter`` in force on this thread, or None.  Autograd's
    device threads inherit the modes of the thread that called
    ``backward``, so a backward marker finds the counter too."""
    if not torch._C._len_torch_dispatch_stack():
        return None
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, OpCounter):
            return mode
    return None


class _Trip(torch.autograd.Function):
    """Identity on ``x`` that marks a trip's boundary in the forward and,
    reversed, in the backward."""

    @staticmethod
    def forward(ctx, x, counter, loop, opening):
        ctx.counter, ctx.loop, ctx.opening = counter, loop, opening
        if opening:
            counter.enter(f"scan:{loop}")
        else:
            counter.leave()
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        # the backward meets the closing marker first
        if ctx.opening:
            ctx.counter.leave()
        else:
            ctx.counter.enter(f"scan:{ctx.loop}.grad")
        return grad, None, None, None


def open_trip(x: torch.Tensor, loop: str) -> torch.Tensor:
    """Mark the start of one trip of the layer loop ``loop`` on the carry
    ``x``; ``x`` itself when no counter is active."""
    counter = active_counter()
    return x if counter is None else _Trip.apply(x, counter, loop, True)


def close_trip(x: torch.Tensor, loop: str) -> torch.Tensor:
    """Mark the end of the trip ``open_trip`` started."""
    counter = active_counter()
    return x if counter is None else _Trip.apply(x, counter, loop, False)


@contextlib.contextmanager
def identical_trips(n: int, *tensors: torch.Tensor):
    """How many of a loop's ``n`` trips to run, where every trip runs the
    same ops on the same shapes: ``with identical_trips(n, x) as k: for i
    in range(k): ...``.  ``k`` is ``n``, but on meta tensors under a
    counter, where no value is computed and no trip can differ from
    another, it is 2, and each of the two trips' ops counts ``n / 2``
    times, as the walker multiplies a ``while`` body by its trip count.
    Two trips, not one, so that the live bytes see a trip's temporaries
    overlap the next's, as they do from every trip to the next."""
    counter = active_counter()
    if counter is None or n <= 2 or not all(t.is_meta for t in tensors):
        yield n
        return
    with counter._lock:
        outer = counter._weight
        counter._weight = outer * n / 2
    try:
        yield 2
    finally:
        with counter._lock:
            counter._weight = outer


def count_ops(fn: Callable, *args, **kwargs) -> Tuple[OpCounter, Any]:
    """Run ``fn(*args, **kwargs)`` once under a new counter; returns the
    finished counter and ``fn``'s result."""
    with OpCounter() as counter:
        out = fn(*args, **kwargs)
    counter.finish()
    return counter, out


def analyze(fn: Callable, *args, **kwargs) -> OpCost:
    """The whole cost of one run of ``fn(*args, **kwargs)`` (the walker's
    ``analyze_hlo``)."""
    return count_ops(fn, *args, **kwargs)[0].total


def sample_breakdown(counter: OpCounter, max_samples: int = 4096):
    """Ordered ``(label, OpCost, count)`` samples of a finished counter.

    As the walker's: glue runs are one sample each; the consecutive trips
    of one loop (one label) are that loop, collapsed into one run of
    ``count`` trips when every trip cost the same (a stack of identical
    layers), and a loop of more than ``max_samples`` trips becomes
    ``max_samples`` samples of its cost spread evenly.
    """
    groups: List[Tuple[str, List[OpCost]]] = []
    for label, cost in counter.runs:
        if label != "glue" and groups and groups[-1][0] == label:
            groups[-1][1].append(cost)
        else:
            groups.append((label, [cost]))
    out = []
    for label, costs in groups:
        n = len(costs)
        if n > max_samples:
            total = OpCost()
            for c in costs:
                total = total.add(c)
            out.append((label, total.scaled(1.0 / max_samples), max_samples))
        elif all(c == costs[0] for c in costs[1:]):
            out.append((label, costs[0], n))
        else:
            out.extend((label, c, 1) for c in costs)
    return out


def attribute_axes(cost: OpCost,
                   mesh_shape: Dict[str, int]) -> Dict[str, float]:
    """Map collective wire bytes to mesh axes by group stride (the walker's
    ``attribute_axes``).

    mesh axes are row-major: last axis has stride 1 in ranks.
    """
    axes = list(mesh_shape.items())                     # [(name, size), ...]
    strides = {}
    s = 1
    for name, size in reversed(axes):
        strides[name] = s
        s *= size
    out: Dict[str, float] = defaultdict(float)
    for c in cost.collectives:
        matched = None
        for name, size in axes:
            if c.stride == strides[name] and c.group_size <= size:
                matched = name
                break
        if matched is None:
            # groups spanning multiple axes (e.g. ('data','model')) —
            # match by total span
            for name, size in axes:
                if c.group_size == size:
                    matched = name
                    break
        out[matched or "unknown"] += c.total_bytes
    return dict(out)

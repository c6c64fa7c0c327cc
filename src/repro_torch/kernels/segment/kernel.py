"""Synapse's fused segment loop on a CUDA card: one launch a segment.

``csrc/segment.cu`` walks a ``FusedSegment``'s int32 (n, 3) table on the
device: per row, ``row[0]`` iterations of the compute atom's burn (the
carry y starts at x and runs on across rows), then ``row[1]`` passes over
the memory atom's ring (its pass counter runs on across rows and
launches), then ``row[2]`` steps of the collective atom's loop body on the
wire carry w (a mesh's n shards of ``COLL_BLOCK_ELEMS`` on this device,
stepped in place), with a grid barrier between rows so row r + 1 starts
only when row r is done everywhere.  Tiles 64, 128 and 256 (``TILES``),
the burn's cluster tiles.  The source says what bounds it and why it is
shaped so.

The wire carry lives, for the length of a launch, in the shared memory of
the CTAs (each thread's columns in the other CTA of its cluster), beside
the burn's panel: ``wire_share_bytes`` a CTA, which bounds the shards a
carry may have (``max_wire_shards``; more raise before any launch).

The kernel counts, on the device, the burn iterations, ring passes and
collective steps that every CTA ran.  ``SegmentRun.settle()``, called
after the caller's sync, reads them back, raises unless they are the
table's sums, and adds them to ``iterations``, ``passes`` and ``steps``:
the proof, in any process, that a segment burned, streamed and moved
what its report says.

``run_segment(..., timed=True)`` launches the timed kernel instead, the
same loop with a stamp of the device's nanosecond clock before the first
row and at each row's end: ``SegmentRun.stamps``, read after the sync,
holds one int64 a table row (0 where the kernel skipped the row) and the
first row's start last.  ``SegmentRun.burn_ns`` holds two more: the ns
the burning CTAs waited for a row of y to be published (lane 0 of warp 0
in each, while it waited) and the ns they spent in their burns, each
summed over those CTAs.  The plain version takes no stamps.

``run_segment`` launches the kernel for CUDA tensors and the plain version
(``ref.run_segment``) for CPU tensors; anything else raises.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.collective.kernel import KIND_CODES
from repro_torch.kernels.memory_atom.kernel import Ring, check_ring
from repro_torch.kernels.segment import ref

#: the tiles the kernel's burn takes (the compute atom's cluster tiles)
TILES = (64, 128, 256)
#: threads a CTA (csrc/burn.cuh ``kThreads``)
CTA_THREADS = 256
#: shared memory a CTA may take on an H100 SXM
#: (``cudaDevAttrMaxSharedMemoryPerBlockOptin``: 227 KB); on the card the
#: limit is the device's own
SMEM_LIMIT_H100 = 232448

#: kernel launches issued by ``run_segment`` (one a segment; CUDA only)
launches = 0
#: of those, the launches whose table has collective steps (the wire leg)
wire_launches = 0
#: burn iterations, ring passes and collective steps those launches ran,
#: as the device counted them (added by ``SegmentRun.settle``)
iterations = 0
passes = 0
steps = 0
#: guards the counters: a thread fleet launches segments from several
#: threads at once
_count_lock = threading.Lock()


def burn_smem_bytes(tile: int) -> int:
    """Shared memory a CTA gives the burn at ``tile`` (``Burn<T>::kSmem``
    of csrc/burn.cuh): two copies of the 4-row panel, each row padded by
    4 floats after every 32, and an 8-byte mbarrier a row a copy."""
    return 2 * 4 * (tile + tile // 8) * 4 + 2 * 4 * 8


def wire_share_bytes(n: int, inner: int, grid: int) -> int:
    """Shared memory a CTA gives a wire carry of ``n`` shards of ``inner``
    float32 on a grid of ``grid`` CTAs (``coll_share_bytes`` of
    csrc/coll.cuh): the n elements of every column its peer's threads
    own, each thread ``ceil(inner / threads)`` columns."""
    threads = grid * CTA_THREADS
    return n * (-(-inner // threads)) * CTA_THREADS * 4


def max_wire_shards(tile: int, inner: int, grid: int,
                    limit: int = SMEM_LIMIT_H100) -> int:
    """The most shards a wire carry of ``inner`` float32 a shard may have
    beside the burn at ``tile``, within ``limit`` bytes a CTA."""
    return (limit - burn_smem_bytes(tile)) // wire_share_bytes(1, inner,
                                                                 grid)


def check_wire_fits(tile: int, n: int, inner: int, grid: int,
                    limit: int = SMEM_LIMIT_H100) -> int:
    """The shared memory a CTA of a launch with this carry takes; raises
    ValueError, naming the limit, when it does not fit."""
    need = burn_smem_bytes(tile) + wire_share_bytes(n, inner, grid)
    if need > limit:
        raise ValueError(
            f"a segment's wire carry of {n} shards of {inner} float32 "
            f"needs {need} bytes of shared memory a CTA at tile {tile} on "
            f"{grid} CTAs, beyond the limit of {limit} bytes: at most "
            f"{max_wire_shards(tile, inner, grid, limit)} shards")
    return need


def grid_info(tile: int, device, wire=None) -> dict:
    """How a segment at ``tile`` launches on a CUDA ``device``, with a
    wire carry of shape ``wire`` (n, inner) or none: its grid, the CTAs
    that burn, the active clusters the occupancy query allows, the shared
    memory a CTA takes and the device's limit.  Every launch is
    cooperative (the row barrier is a grid sync); a launch the driver
    refuses raises, and a carry whose share does not fit raises
    ValueError before any launch."""
    dev = torch.device(device)
    index = dev.index if dev.index is not None \
        else torch.cuda.current_device()
    lib = build.load()
    info = (ctypes.c_int64 * 5)()
    build.check(lib, lib.synapse_segment_grid(tile, 0, 0, index, info),
                "segment grid")
    if wire is not None:
        check_wire_fits(tile, wire[0], wire[1], info[0], info[4])
        build.check(lib, lib.synapse_segment_grid(
            tile, wire[0], wire[1], index, info), "segment grid")
    return {"grid": info[0], "burn_ctas": info[1], "max_clusters": info[2],
            "smem_bytes": info[3], "smem_limit": info[4]}


def check_input(table, x: Optional[torch.Tensor], ring: Optional[Ring],
                w: Optional[torch.Tensor] = None,
                kind: str = "all-reduce") -> np.ndarray:
    """Validate a segment; returns its table as (n, 3) int32."""
    t = np.asarray(table)
    if t.dtype != np.int32 or t.ndim != 2 or t.shape[1] != 3 \
            or t.shape[0] == 0:
        raise ValueError(f"a segment table is a non-empty (n, 3) int32 "
                         f"array, got {t.dtype} {t.shape}")
    if (t < 0).any():
        raise ValueError("a segment table holds no negative count")
    ci, mi, wi = (int(t[:, i].sum()) for i in range(3))
    devices = set()
    if wi:
        if not isinstance(w, torch.Tensor) or w.dtype != torch.float32 \
                or w.dim() != 2 or w.numel() == 0 \
                or not w.is_contiguous() or kind not in KIND_CODES:
            raise ValueError(
                f"a segment with collective steps takes a contiguous "
                f"float32 (n, block) wire carry and a kind in "
                f"{tuple(KIND_CODES)}, got "
                f"{None if w is None else (w.dtype, tuple(w.shape))}, "
                f"{kind!r}")
        devices.add(w.device)
    if ci:
        if not isinstance(x, torch.Tensor) or x.dtype != torch.float32 \
                or x.dim() != 2 or x.shape[0] != x.shape[1] \
                or x.shape[0] not in TILES or not x.is_contiguous():
            raise ValueError(
                f"a segment that burns takes a contiguous float32 "
                f"[tile, tile] operand with tile in {TILES}, got "
                f"{None if x is None else (x.dtype, tuple(x.shape))}")
        devices.add(x.device)
    if mi:
        check_ring(ring)
        devices.add(ring.device)
    if len(devices) > 1:
        raise ValueError(f"the segment's operands lie on {devices}")
    dev = next(iter(devices), None)
    if dev is not None and dev.type not in ("cpu", "cuda"):
        raise ValueError(f"a segment runs on cpu or cuda, not {dev}")
    if dev is not None and dev.type == "cuda" and (
            (ci and x.data_ptr() % 16) or (wi and w.data_ptr() % 16)):
        raise ValueError("a segment's operands must be 16-byte aligned")
    return t


class SegmentRun:
    """A launched segment: ``y``, the burn's carry after the table's compute
    iterations (None when no row burns), ``slot``, the ring block its last
    pass wrote (None when no row streams), and ``w``, the wire carry its
    collective steps stepped (None when no row has any).  ``settle()``
    after the caller's sync checks the device counters (a no-op on the
    CPU, and for ``SegmentRunner``'s ``"torch"`` loop, whose carries it
    also holds).  ``stamps``: the timed kernel's row stamps, else None;
    ``burn_ns``: its two burn sums (ns waited for y, ns burned), else
    None."""

    __slots__ = ("y", "slot", "w", "stamps", "burn_ns", "_counts", "_want",
                 "_settled")

    def __init__(self, y, slot, w=None, counts=None, want=None, stamps=None,
                 burn_ns=None):
        self.y, self.slot, self.w, self.stamps = y, slot, w, stamps
        self.burn_ns = burn_ns
        self._counts, self._want = counts, want
        self._settled = counts is None

    def tensors(self) -> tuple:
        """The carries, for ``repro_torch.device.sync``."""
        return self.y, self.slot, self.w

    def settle(self) -> None:
        global iterations, passes, steps
        if self._settled:
            return
        self._settled = True
        (ci, burn_ctas), (mi, grid), wi = self._want
        got_c, got_m, got_w = self._counts.tolist()
        if got_c != ci * burn_ctas or got_m != mi * grid \
                or got_w != wi * grid:
            raise RuntimeError(
                f"segment kernel: the device counted {got_c} burn "
                f"iterations over {burn_ctas} CTAs, {got_m} ring passes "
                f"and {got_w} collective steps over {grid}, want {ci}, "
                f"{mi} and {wi} each")
        with _count_lock:
            iterations += ci
            passes += mi
            steps += wi


def run_segment(table, x: Optional[torch.Tensor], ring: Optional[Ring],
                w: Optional[torch.Tensor] = None,
                kind: str = "all-reduce", timed: bool = False) -> SegmentRun:
    """Run a segment's table: burns on ``x`` [tile, tile] (may be None when
    no row burns), passes over ``ring`` (may be None when no row streams),
    collective steps of ``kind`` on the wire carry ``w`` [n, block], in
    place (may be None when no row has any); ``timed`` launches the timed
    kernel (a card only)."""
    global launches, wire_launches
    t = check_input(table, x, ring, w, kind)
    ci, mi, wi = (int(t[:, i].sum()) for i in range(3))
    wire = w if wi else None
    dev = x.device if ci else ring.device if mi else \
        w.device if wi else None
    if dev is None:
        return SegmentRun(None, None)
    if dev.type == "cpu":
        start = ring.claim(mi) if mi else 0
        y = ref.run_segment(t, x, ring.data if mi else None, start=start,
                            w=wire, kind=kind)
        return SegmentRun(y, ring.slot(start + mi - 1) if mi else None,
                          wire)
    tile = x.shape[0] if ci else TILES[0]
    # before the ring numbers any pass: a carry that does not fit raises
    info = grid_info(tile, dev, tuple(w.shape) if wi else None)
    start = ring.claim(mi) if mi else 0
    slot = ring.slot(start + mi - 1) if mi else None
    lib = build.load()
    stream = torch.cuda.current_stream(dev)
    # the table crosses on the launch stream, from pinned memory
    table_dev = torch.from_numpy(np.ascontiguousarray(t)).pin_memory().to(
        dev, non_blocking=True)
    # the counts, the row stamps and the burn's two sums, zeroed by one
    # fill
    n = t.shape[0]
    buf = torch.zeros(3 + (n + 3 if timed else 0), dtype=torch.int64,
                      device=dev)
    counts = buf[:3]
    stamps, burn_ns = (buf[3:4 + n], buf[4 + n:]) if timed else (None, None)
    out = torch.empty_like(x) if ci else None
    err = lib.synapse_segment(
        table_dev.data_ptr(), t.shape[0], x.data_ptr() if ci else None,
        out.data_ptr() if ci else None, ring.data.data_ptr() if mi else None,
        ring.data.shape[1] if mi else 0, ring.slots if mi else 1, start,
        tile, ci, w.data_ptr() if wi else None, w.shape[0] if wi else 0,
        w.shape[1] if wi else 0, KIND_CODES[kind], counts.data_ptr(),
        stamps.data_ptr() if timed else None, dev.index, stream.cuda_stream)
    build.check(lib, err, "segment")
    with _count_lock:
        launches += 1
        wire_launches += bool(wi)
    return SegmentRun(out, slot, wire, counts,
                      ((ci, info["burn_ctas"]), (mi, info["grid"]), wi),
                      stamps, burn_ns)

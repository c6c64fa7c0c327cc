"""Synapse's fused segment loop on a CUDA card: one launch a segment.

``csrc/segment.cu`` walks a ``FusedSegment``'s int32 (n, 3) table on the
device: per row, ``row[0]`` iterations of the compute atom's burn (the
carry y starts at x and runs on across rows), then ``row[1]`` passes over
the memory atom's ring (its pass counter runs on across rows and
launches), with a grid barrier between rows so row r + 1 starts only when
row r is done everywhere.  Tiles 64, 128 and 256 (``TILES``), the burn's
cluster tiles.  The source says what bounds it and why it is shaped so.

The kernel counts, on the device, the burn iterations and ring passes that
every CTA ran.  ``SegmentRun.settle()``, called after the caller's sync,
reads them back, raises unless they are the table's sums, and adds them
to ``iterations`` and ``passes``: the proof, in any process, that a
segment burned and streamed what its report says.

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
from repro_torch.kernels.memory_atom.kernel import Ring, check_ring
from repro_torch.kernels.segment import ref

#: the tiles the kernel's burn takes (the compute atom's cluster tiles)
TILES = (64, 128, 256)

#: kernel launches issued by ``run_segment`` (one a segment; CUDA only)
launches = 0
#: burn iterations and ring passes those launches ran, as the device
#: counted them (added by ``SegmentRun.settle``)
iterations = 0
passes = 0
#: guards the counters: a thread fleet launches segments from several
#: threads at once
_count_lock = threading.Lock()


def grid_info(tile: int, device) -> dict:
    """How a segment at ``tile`` launches on a CUDA ``device``: its grid,
    the CTAs that burn, and the active clusters the occupancy query
    allows.  Every launch is cooperative (the row barrier is a grid sync);
    a launch the driver refuses raises."""
    dev = torch.device(device)
    lib = build.load()
    info = (ctypes.c_int64 * 3)()
    build.check(lib, lib.synapse_segment_grid(
        tile, dev.index if dev.index is not None
        else torch.cuda.current_device(), info), "segment grid")
    return {"grid": info[0], "burn_ctas": info[1], "max_clusters": info[2]}


def check_input(table, x: Optional[torch.Tensor],
                ring: Optional[Ring]) -> np.ndarray:
    """Validate a segment; returns its table as (n, 3) int32."""
    t = np.asarray(table)
    if t.dtype != np.int32 or t.ndim != 2 or t.shape[1] != 3 \
            or t.shape[0] == 0:
        raise ValueError(f"a segment table is a non-empty (n, 3) int32 "
                         f"array, got {t.dtype} {t.shape}")
    if (t < 0).any():
        raise ValueError("a segment table holds no negative count")
    if t[:, 2].any():
        raise ValueError("the segment kernel runs no collective steps: "
                         "row[2] must be 0")
    ci, mi = int(t[:, 0].sum()), int(t[:, 1].sum())
    devices = set()
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
        raise ValueError(f"the operand and the ring lie on {devices}")
    dev = next(iter(devices), None)
    if dev is not None and dev.type not in ("cpu", "cuda"):
        raise ValueError(f"a segment runs on cpu or cuda, not {dev}")
    if dev is not None and dev.type == "cuda" and ci and x.data_ptr() % 16:
        raise ValueError("a segment's operand must be 16-byte aligned")
    return t


class SegmentRun:
    """A launched segment: ``y``, the burn's carry after the table's compute
    iterations (None when no row burns), and ``slot``, the ring block its
    last pass wrote (None when no row streams).  ``settle()`` after the
    caller's sync checks the device counters (a no-op on the CPU, and for
    ``SegmentRunner``'s ``"torch"`` loop, whose carries it also holds)."""

    __slots__ = ("y", "slot", "_counts", "_want", "_settled")

    def __init__(self, y, slot, counts=None, want=None):
        self.y, self.slot = y, slot
        self._counts, self._want = counts, want
        self._settled = counts is None

    def settle(self) -> None:
        global iterations, passes
        if self._settled:
            return
        self._settled = True
        (ci, burn_ctas), (mi, grid) = self._want
        got_c, got_m = self._counts.tolist()
        if got_c != ci * burn_ctas or got_m != mi * grid:
            raise RuntimeError(
                f"segment kernel: the device counted {got_c} burn "
                f"iterations over {burn_ctas} CTAs and {got_m} ring passes "
                f"over {grid}, want {ci} and {mi} each")
        with _count_lock:
            iterations += ci
            passes += mi


def run_segment(table, x: Optional[torch.Tensor],
                ring: Optional[Ring]) -> SegmentRun:
    """Run a segment's table: burns on ``x`` [tile, tile] (may be None when
    no row burns), passes over ``ring`` (may be None when no row
    streams)."""
    global launches
    t = check_input(table, x, ring)
    ci, mi = int(t[:, 0].sum()), int(t[:, 1].sum())
    start = ring.claim(mi) if mi else 0
    slot = ring.slot(start + mi - 1) if mi else None
    dev = x.device if ci else ring.device if mi else None
    if dev is None:
        return SegmentRun(None, None)
    if dev.type == "cpu":
        y = ref.run_segment(t, x, ring.data if mi else None, start=start)
        return SegmentRun(y, slot)
    lib = build.load()
    tile = x.shape[0] if ci else TILES[0]
    info = grid_info(tile, dev)
    stream = torch.cuda.current_stream(dev)
    # the table crosses on the launch stream, from pinned memory
    table_dev = torch.from_numpy(np.ascontiguousarray(t)).pin_memory().to(
        dev, non_blocking=True)
    counts = torch.zeros(2, dtype=torch.int64, device=dev)
    out = torch.empty_like(x) if ci else None
    err = lib.synapse_segment(
        table_dev.data_ptr(), t.shape[0], x.data_ptr() if ci else None,
        out.data_ptr() if ci else None, ring.data.data_ptr() if mi else None,
        ring.data.shape[1] if mi else 0, ring.slots if mi else 1, start,
        tile, ci, counts.data_ptr(), dev.index, stream.cuda_stream)
    build.check(lib, err, "segment")
    with _count_lock:
        launches += 1
    return SegmentRun(out, slot, counts,
                      ((ci, info["burn_ctas"]), (mi, info["grid"])))

"""The port's in-process spans and counters, on the device trace's clock.

A span is a named host interval inside the program (``Emulator.emulate``
and its parts, a segment's launch and wait, a served wave and its parts),
stamped by ``clock.epoch_ns()``: the clock ``torch.profiler`` stamps
device activity on, so a span lies over the device timeline of the same
run.  It records its name, start and end, its own id, its parent's (the
innermost span open on its thread when it opened) and its request's (its
root's id), and a few small attributes (``Span.attrs``).

Counters are plain integers, bumped when the span that carries them
closes (``Span.count``).  A segment launched while tracing records the
device time of each of its rows (``row_times``), stamped by the timed
segment kernel, and its ``segment.wait`` span counts the ns the kernel's
burning CTAs waited for a row of y (``segment.burn_wait_ns``) and the ns
they burned (``segment.burn_ns``), summed on the device's clock.

Tracing is on while ``torch.profiler`` records (between a profile's
``start()`` and ``stop()``) or inside ``recording()``.  Off, ``span()``
costs one check: it takes no clock reading, allocates nothing and returns
a shared context whose ``with`` target is None.

The recorder keeps what it records in memory until it is read, in
bounded buffers: the oldest entries drop first, counted in ``dropped``.
``window(t0_ns, t1_ns)`` returns what lies in an interval as plain data.
Nothing is written to disk.
"""
from __future__ import annotations

import itertools
import threading
from collections import deque
from contextlib import contextmanager
from typing import Dict, List, Optional

from torch.autograd import profiler as _profiler

from repro_torch.obs.clock import epoch_ns

#: closed spans kept, and segment launches whose row times are kept
CAPACITY = 1 << 16
ROW_CAPACITY = 1 << 12

_forced = 0                     # open ``recording()`` blocks
_forced_lock = threading.Lock()


def on() -> bool:
    """Whether spans record: ``torch.profiler`` records, or a
    ``recording()`` block is open."""
    return _forced > 0 or _profiler._is_profiler_enabled


class Span:
    """One open or closed span; ``count`` bumps a counter at its close."""

    __slots__ = ("name", "id", "parent", "request", "start_ns", "end_ns",
                 "attrs", "counts", "_rec")

    def __init__(self, rec: "SpanRecorder", name: str, id_: int,
                 parent: Optional["Span"]):
        self.name, self.id, self._rec = name, id_, rec
        self.parent = parent.id if parent is not None else None
        self.request = parent.request if parent is not None else id_
        self.attrs: Dict = {}
        self.counts: Dict[str, int] = {}
        self.end_ns = 0
        self.start_ns = epoch_ns()

    def count(self, name: str, n: int) -> None:
        self.counts[name] = self.counts.get(name, 0) + int(n)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = epoch_ns()
        self._rec._close(self)
        return False

    def to_dict(self) -> Dict:
        return {"name": self.name, "id": self.id, "parent": self.parent,
                "request": self.request, "start_ns": self.start_ns,
                "end_ns": self.end_ns, "attrs": dict(self.attrs),
                "counts": dict(self.counts)}


class _Off:
    """The span of a program that is not tracing: does nothing."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


OFF = _Off()


class SpanRecorder:
    def __init__(self, capacity: int = CAPACITY,
                 row_capacity: int = ROW_CAPACITY):
        self.spans: deque = deque(maxlen=capacity)
        self.rows: deque = deque(maxlen=row_capacity)
        #: counter totals over every span closed while recording
        self.counters: Dict[str, int] = {}
        #: entries dropped from the full buffers, oldest first
        self.dropped = {"spans": 0, "rows": 0}
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self._local = threading.local()

    def _stack(self) -> List[Span]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def open(self, name: str) -> Span:
        st = self._stack()
        sp = Span(self, name, next(self._ids), st[-1] if st else None)
        st.append(sp)
        return sp

    def _close(self, sp: Span) -> None:
        st = self._stack()
        if sp in st:
            del st[st.index(sp):]
        with self._lock:
            for k, n in sp.counts.items():
                self.counters[k] = self.counters.get(k, 0) + n
            if len(self.spans) == self.spans.maxlen:
                self.dropped["spans"] += 1
            self.spans.append(sp)

    def current(self) -> Optional[Span]:
        st = self._stack()
        return st[-1] if st else None

    def row_times(self, ns: List[int], flops: List[float],
                  nbytes: List[float]) -> None:
        """One segment launch's rows that ran: each row's device
        nanoseconds and the operations and bytes its profile planned."""
        cur = self.current()
        rec = {"t_ns": epoch_ns(),
               "span": cur.id if cur is not None else None,
               "request": cur.request if cur is not None else None,
               "ns": list(ns), "flops": list(flops), "bytes": list(nbytes)}
        with self._lock:
            if len(self.rows) == self.rows.maxlen:
                self.dropped["rows"] += 1
            self.rows.append(rec)

    def window(self, t0_ns: int, t1_ns: int) -> Dict:
        """The spans that lie in [t0_ns, t1_ns], the counters summed over
        them, the row times recorded in it, and the drop counts."""
        with self._lock:
            spans = [s for s in self.spans
                     if s.start_ns >= t0_ns and s.end_ns <= t1_ns]
            rows = [r for r in self.rows if t0_ns <= r["t_ns"] <= t1_ns]
            dropped = dict(self.dropped)
        counters: Dict[str, int] = {}
        for s in spans:
            for k, n in s.counts.items():
                counters[k] = counters.get(k, 0) + n
        return {"spans": [s.to_dict() for s in spans],
                "counters": counters, "rows": rows, "dropped": dropped}

    def clear(self) -> None:
        with self._lock:
            self.spans.clear()
            self.rows.clear()
            self.counters.clear()
            self.dropped = {"spans": 0, "rows": 0}


#: the process's recorder
RECORDER = SpanRecorder()


def span(name: str):
    """A span named ``name`` for a ``with`` block, whose target is the
    ``Span`` (None when tracing is off)."""
    if not on():
        return OFF
    return RECORDER.open(name)


def row_times(ns, flops, nbytes) -> None:
    RECORDER.row_times(ns, flops, nbytes)


def window(t0_ns: int, t1_ns: int) -> Dict:
    return RECORDER.window(t0_ns, t1_ns)


@contextmanager
def recording():
    """Record spans inside the block, whether or not a profiler runs."""
    global _forced
    with _forced_lock:
        _forced += 1
    try:
        yield RECORDER
    finally:
        with _forced_lock:
            _forced -= 1

"""One clock domain for every stamp the fleet takes.

Timestamps used to mix ``time.time()`` call sites across coordinator
and workers: a wall-clock step (NTP slew, suspend/resume, a test
freezing time) could make ``queue_s``/``replay_s`` negative.  This
module fixes the domain once:

* ``now()`` is the stamp everything records — ``time.monotonic()``, so
  durations between any two local stamps are non-negative by
  construction.
* ``wall(t)`` maps a monotonic stamp back to an absolute wall time via
  an anchor pair captured at import (``anchor()`` exposes it), for
  humans and trace viewers that want real dates.
* ``ClockSync`` estimates a remote peer's clock offset from handshake
  echoes so remote monotonic stamps rebase onto the local timeline.

Monotonic clocks are *per-process* (arbitrary epoch), so a raw remote
stamp is meaningless locally — every remote event must pass through a
``ClockSync`` before it lands on the coordinator timeline.

``epoch_ns()`` is the one exception: the program's spans
(``obs.spans``) are laid over a device trace, so they stamp on the clock
``torch.profiler`` stamps device activity on, the epoch in nanoseconds.
"""
from __future__ import annotations

import time
from typing import Optional, Tuple

# Captured once at import: the pair that lets any monotonic stamp in
# this process be rendered as a wall time.
_ANCHOR_MONO: float = time.monotonic()
_ANCHOR_WALL: float = time.time()


def now() -> float:
    """Monotonic stamp — the one clock every event/timing records."""
    return time.monotonic()


def epoch_ns() -> int:
    """The device trace's clock: ``time.time_ns()``, the stamp of every
    span of ``obs.spans``."""
    return time.time_ns()


def wall(t_mono: Optional[float] = None) -> float:
    """Render a local monotonic stamp as absolute wall time."""
    if t_mono is None:
        t_mono = now()
    return _ANCHOR_WALL + (t_mono - _ANCHOR_MONO)


def anchor() -> Tuple[float, float]:
    """This process's (monotonic, wall) anchor pair."""
    return (_ANCHOR_MONO, _ANCHOR_WALL)


class ClockSync:
    """Per-peer clock-offset estimator (NTP-style, min-RTT sample).

    Each observation is one echo: the local side stamps ``t_sent``,
    the peer replies carrying its own clock reading ``t_remote``, and
    the local side stamps ``t_recv`` on arrival.  Assuming symmetric
    paths the peer read its clock at local time ``(t_sent+t_recv)/2``,
    so ``offset = t_remote - midpoint``.  The estimate with the
    smallest round-trip bounds the error tightest, so only the min-RTT
    sample is kept — piggybacking an echo on every result frame keeps
    refining it for free.

    Plain picklable attributes: syncs ride inside reports.
    """

    def __init__(self) -> None:
        self.offset: float = 0.0   # remote_clock - local_clock
        self.rtt: Optional[float] = None   # best (smallest) RTT seen
        self.samples: int = 0

    def observe(self, t_sent: float, t_remote: float, t_recv: float) -> None:
        """Fold in one echo (all stamps monotonic, each in its own
        process's domain)."""
        rtt = max(0.0, t_recv - t_sent)
        self.samples += 1
        if self.rtt is None or rtt < self.rtt:
            self.rtt = rtt
            self.offset = t_remote - (t_sent + t_recv) / 2.0

    @property
    def synced(self) -> bool:
        return self.samples > 0

    def to_local(self, t_remote: float) -> float:
        """Rebase a remote monotonic stamp onto the local clock."""
        return t_remote - self.offset

    def to_dict(self) -> dict:
        return {"offset": self.offset, "rtt": self.rtt,
                "samples": self.samples}

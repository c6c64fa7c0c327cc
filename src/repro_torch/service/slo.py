"""Streaming SLO accounting: bounded quantile sketch, windows, chaos join.

The service's product is the latency distribution under offered load —
p50/p99/p999, goodput vs offered, violations against a declared
:class:`SLO` — computed *streaming*: a load run may push millions of
requests, so nothing here stores per-request latencies.

:class:`LatencySketch` is a log-bucketed histogram: bucket boundaries
grow geometrically by ``growth`` (default 1.05), so any quantile read
back is within ``growth - 1`` relative error of the exact sample
quantile while memory stays a few hundred ints regardless of stream
length.  Merging two sketches adds bucket counts — exactly associative,
so per-window sketches roll up to run totals without re-observing
anything — and a sketch pickles, so remote agents could ship theirs
home.

:class:`SLOEngine` keys sketches by fixed time window and joins
``FleetReport.recovery["fault_events"]`` (``(opened, repaired)`` stamps
from the executor's MTTR bookkeeping) against that timeline: the windows
a fault overlaps are marked, so a kill-mid-storm visibly lands in the
marked windows' p999 rather than dissolving into the run average.  The
attribution interval extends one window past repair — the request a
death interrupted completes only *after* the replacement warms, so its
latency lands just after the repair stamp.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

__all__ = ["SLO", "LatencySketch", "SLOEngine"]


@dataclass(frozen=True)
class SLO:
    """A declared objective: ``percentile`` of latencies must come in at
    or under ``target_ms``.  ``SLO(200, 0.99)`` reads "p99 under 200ms"."""

    target_ms: float
    percentile: float = 0.99

    def __post_init__(self):
        if self.target_ms <= 0:
            raise ValueError("target_ms must be > 0")
        if not 0.0 < self.percentile < 1.0:
            raise ValueError("percentile must be in (0, 1), got "
                             f"{self.percentile}")

    def met(self, latency_s: float) -> bool:
        return latency_s * 1e3 <= self.target_ms

    def to_dict(self) -> Dict:
        return {"target_ms": self.target_ms, "percentile": self.percentile}


class LatencySketch:
    """Bounded-memory streaming quantiles over positive durations.

    Geometric buckets: value ``v`` lands in bucket
    ``floor(log(v / lo) / log(growth))``, and a quantile query returns
    the geometric midpoint of the bucket holding that rank — within
    ``growth - 1`` relative error of the exact sample quantile (the
    midpoint is at most ``sqrt(growth)`` off either edge).  Exact
    ``min``/``max``/``count``/``sum`` ride along, and queries clamp to
    the observed ``[min, max]`` so small samples never report a value
    outside what was seen.

    ``merge`` adds bucket counts elementwise: associative and
    commutative by construction (integer adds), which the tests assert
    literally.  Plain attributes only, so a sketch pickles.
    """

    def __init__(self, lo: float = 1e-6, hi: float = 3600.0,
                 growth: float = 1.05):
        if not 0 < lo < hi:
            raise ValueError("need 0 < lo < hi")
        if growth <= 1.0:
            raise ValueError("growth must be > 1.0")
        self.lo = lo
        self.hi = hi
        self.growth = growth
        self._log_g = math.log(growth)
        # bucket i covers [lo * g**i, lo * g**(i+1)); +2 for under/overflow
        self.n_buckets = int(math.ceil(math.log(hi / lo) / self._log_g)) + 2
        self.counts = [0] * self.n_buckets
        self.count = 0
        self.total = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    # -- ingest -------------------------------------------------------------

    def _bucket(self, v: float) -> int:
        if v < self.lo:
            return 0                                   # underflow
        if v >= self.hi:
            return self.n_buckets - 1                  # overflow
        return 1 + int(math.log(v / self.lo) / self._log_g)

    def add(self, latency_s: float) -> None:
        if latency_s < 0:
            raise ValueError(f"latency must be >= 0, got {latency_s}")
        self.counts[self._bucket(latency_s)] += 1
        self.count += 1
        self.total += latency_s
        self.min = latency_s if self.min is None else min(self.min,
                                                          latency_s)
        self.max = latency_s if self.max is None else max(self.max,
                                                          latency_s)

    # -- query --------------------------------------------------------------

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """The sketched ``q``-quantile (0 < q <= 1) of everything added."""
        if not 0.0 < q <= 1.0:
            raise ValueError(f"q must be in (0, 1], got {q}")
        if self.count == 0:
            return 0.0
        rank = max(1, math.ceil(q * self.count))
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank:
                if i == 0:                       # underflow: below lo
                    est = self.lo
                elif i == self.n_buckets - 1:    # overflow: clamp to max
                    est = self.max
                else:
                    edge = self.lo * self.growth ** (i - 1)
                    est = edge * math.sqrt(self.growth)  # geometric mid
                return min(max(est, self.min), self.max)
        return self.max                          # pragma: no cover

    # -- combine ------------------------------------------------------------

    def merge(self, other: "LatencySketch") -> "LatencySketch":
        """A new sketch holding both streams (inputs untouched)."""
        if (self.lo, self.hi, self.growth) != (other.lo, other.hi,
                                               other.growth):
            raise ValueError("cannot merge sketches with different "
                             "bucket geometry")
        out = LatencySketch(self.lo, self.hi, self.growth)
        out.counts = [a + b for a, b in zip(self.counts, other.counts)]
        out.count = self.count + other.count
        out.total = self.total + other.total
        mins = [m for m in (self.min, other.min) if m is not None]
        maxs = [m for m in (self.max, other.max) if m is not None]
        out.min = min(mins) if mins else None
        out.max = max(maxs) if maxs else None
        return out

    def __repr__(self):
        return (f"LatencySketch(n={self.count}, p50={self.quantile(0.5):.6f}"
                f", p99={self.quantile(0.99):.6f})")


class SLOEngine:
    """Joins three streams on one run-relative timeline: offered arrivals,
    completed latencies, and fault windows.

    All times are seconds since the run started (the serve layer
    subtracts its ``t0``).  ``observe`` takes the *completion* time and
    the open-loop latency measured from the scheduled arrival — so
    coordinated omission is structurally impossible: a request that sat
    out a worker outage is charged the whole wait, and its latency lands
    in the window where it completed, which the fault join then marks.
    """

    def __init__(self, slo: SLO, *, window_s: float = 1.0,
                 lo: float = 1e-6, hi: float = 3600.0, growth: float = 1.05):
        if window_s <= 0:
            raise ValueError("window_s must be > 0")
        self.slo = slo
        self.window_s = window_s
        self._mk = lambda: LatencySketch(lo, hi, growth)
        self.overall = self._mk()
        self._windows: Dict[int, Dict] = {}
        self.n_offered = 0
        self.n_completed = 0
        self.n_failed = 0
        self.n_violations = 0
        self._faults: List[Tuple[float, float]] = []
        self._t_hi = 0.0

    def _window(self, t: float) -> Dict:
        w = int(t // self.window_s)
        self._t_hi = max(self._t_hi, t)
        win = self._windows.get(w)
        if win is None:
            win = self._windows[w] = {
                "sketch": self._mk(), "offered": 0, "completed": 0,
                "failed": 0, "violations": 0,
            }
        return win

    # -- ingest -------------------------------------------------------------

    def offered(self, t: float) -> None:
        """An arrival was *scheduled* at run-relative ``t``."""
        self.n_offered += 1
        self._window(t)["offered"] += 1

    def observe(self, t_done: float, latency_s: float,
                ok: bool = True) -> None:
        """A request completed at ``t_done`` after ``latency_s`` measured
        from its scheduled arrival (open-loop)."""
        win = self._window(t_done)
        self.n_completed += 1
        win["completed"] += 1
        self.overall.add(latency_s)
        win["sketch"].add(latency_s)
        violated = (not ok) or not self.slo.met(latency_s)
        if not ok:
            self.n_failed += 1
            win["failed"] += 1
        if violated:
            self.n_violations += 1
            win["violations"] += 1

    def fault(self, opened: float, repaired: float) -> None:
        """A fault's MTTR window in run-relative seconds (from
        ``FleetReport.recovery["fault_events"]``, rebased by the serve
        layer's t0)."""
        self._faults.append((opened, repaired))

    # -- report -------------------------------------------------------------

    def _fault_count(self, w: int) -> int:
        """Faults overlapping window ``w``, with the attribution interval
        stretched one window past repair: the interrupted request lands
        just after the repair stamp."""
        t0, t1 = w * self.window_s, (w + 1) * self.window_s
        return sum(1 for o, r in self._faults
                   if o < t1 and (r + self.window_s) >= t0)

    def report(self) -> Dict:
        """The run's SLO accounting as one JSON-ready dict."""
        duration = max(self._t_hi,
                       (max(self._windows) + 1) * self.window_s
                       if self._windows else 0.0)
        n_good = self.n_completed - self.n_violations
        windows = []
        for w in sorted(self._windows):
            win = self._windows[w]
            sk = win["sketch"]
            windows.append({
                "t0": w * self.window_s,
                "offered": win["offered"],
                "completed": win["completed"],
                "failed": win["failed"],
                "violations": win["violations"],
                "faults": self._fault_count(w),
                "p50": sk.quantile(0.50),
                "p99": sk.quantile(0.99),
                "p999": sk.quantile(0.999),
                "max": sk.max or 0.0,
            })
        return {
            "slo": self.slo.to_dict(),
            "window_s": self.window_s,
            "duration_s": duration,
            "n_offered": self.n_offered,
            "n_completed": self.n_completed,
            "n_failed": self.n_failed,
            "n_violations": self.n_violations,
            "offered_hz": self.n_offered / duration if duration else 0.0,
            # goodput: completions that met the SLO, per second offered
            "goodput_hz": n_good / duration if duration else 0.0,
            "p50": self.overall.quantile(0.50),
            "p99": self.overall.quantile(0.99),
            "p999": self.overall.quantile(0.999),
            "mean": self.overall.mean,
            "max": self.overall.max or 0.0,
            "slo_met": (self.overall.quantile(self.slo.percentile) * 1e3
                        <= self.slo.target_ms) if self.n_completed else True,
            "faults": [{"opened": o, "repaired": r, "mttr_s": r - o}
                       for o, r in sorted(self._faults)],
            "windows": windows,
        }

"""Seeded open-loop arrival processes for the live traffic service.

A closed-loop replayer dispatches as fast as the fleet drains — its
"load" is whatever the pool can absorb, and queueing delay is invisible
by construction.  Open-loop load is the opposite contract: requests
arrive on a schedule that does not care how busy the fleet is, so when
the pool falls behind the queue grows and *latency* (not throughput) is
what the run measures.  Everything here emits that schedule.

An :class:`ArrivalProcess` is a frozen, picklable description of a load
shape — Poisson, constant-rate, diurnal ramp, or a recorded trace — that
iterates deterministically into timestamped :class:`Arrival` requests.
Randomized processes draw from a ``random.Random`` seeded with the same
sha256-per-scope discipline as ``ChaosPolicy``
(:func:`repro_torch.fleet.chaos.derive_seed`), and every candidate
ordinal draws the same number of variates whether or not it is accepted, so the
arrival timeline is bit-identical run-to-run and independent of the
fleet that serves it.  A chaos-under-load run is therefore reproducible
end to end from two integers: the arrival seed and the chaos seed.

Iterating a process never mutates it: ``list(p) == list(p)`` always.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from random import Random
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

from repro_torch.fleet.chaos import derive_seed

#: params travel as a sorted ``(key, value)`` tuple so Arrival stays
#: hashable/comparable and two logically-equal requests compare equal
ParamItems = Tuple[Tuple[str, object], ...]


def _freeze_params(params) -> ParamItems:
    if params is None:
        return ()
    if isinstance(params, dict):
        return tuple(sorted(params.items()))
    return tuple((str(k), v) for k, v in params)


@dataclass(frozen=True)
class Arrival:
    """One scheduled request: fire ``scenario(**params)`` at ``t`` seconds
    after the run starts.  ``t`` is run-relative virtual time — the serve
    layer maps it onto the wall clock (optionally time-scaled)."""

    t: float
    scenario: str
    params: ParamItems = ()

    def __post_init__(self):
        object.__setattr__(self, "params", _freeze_params(self.params))
        if self.t < 0:
            raise ValueError(f"arrival time must be >= 0, got {self.t}")

    @property
    def kwargs(self) -> Dict[str, object]:
        """``params`` in the form ``repro_torch.scenarios.generate``
        takes."""
        return dict(self.params)


@dataclass(frozen=True)
class ArrivalProcess:
    """Base contract: a bounded, deterministic iterable of ``Arrival``s.

    Every process must be bounded by ``n_requests`` and/or ``duration_s``
    (an unbounded load run is a typo, not a workload).  Subclasses
    implement ``_times`` — a lazy nondecreasing time stream — and declare
    a ``kind`` tag that scopes their RNG stream, so two processes in one
    run (say a Poisson floor plus a diurnal ramp) never share variates
    even under the same seed.
    """

    scenario: str = "serving_traffic"
    params: ParamItems = ()
    seed: int = 0
    n_requests: Optional[int] = None
    duration_s: Optional[float] = None

    kind = "base"

    def __post_init__(self):
        object.__setattr__(self, "params", _freeze_params(self.params))
        if self.n_requests is None and self.duration_s is None:
            raise ValueError(
                f"{type(self).__name__} must be bounded: pass n_requests=N "
                "and/or duration_s=T (open-loop load with no bound never "
                "stops arriving)")
        if self.n_requests is not None and self.n_requests < 0:
            raise ValueError("n_requests must be >= 0")
        if self.duration_s is not None and self.duration_s < 0:
            raise ValueError("duration_s must be >= 0")

    # -- subclass surface ---------------------------------------------------

    def _times(self, rng: Random) -> Iterator[float]:
        raise NotImplementedError

    def _rng(self) -> Random:
        """Fresh per-iteration RNG: the stream is a pure function of
        ``(seed, kind, scenario)``, so iterating twice replays exactly."""
        return Random(derive_seed(self.seed,
                                  f"arrivals:{self.kind}:{self.scenario}"))

    # -- iteration ----------------------------------------------------------

    def __iter__(self) -> Iterator[Arrival]:
        n = 0
        for t in self._times(self._rng()):
            if self.n_requests is not None and n >= self.n_requests:
                return
            if self.duration_s is not None and t > self.duration_s:
                return
            yield Arrival(t=t, scenario=self.scenario, params=self.params)
            n += 1

    def trace(self) -> "TraceArrivals":
        """Materialize into a replayable trace (the recorded-log form)."""
        return TraceArrivals(log=tuple(self), n_requests=self.n_requests,
                             duration_s=self.duration_s)


@dataclass(frozen=True)
class ConstantArrivals(ArrivalProcess):
    """Metronome load: request ``i`` arrives at exactly ``i / rate_hz``.
    The sharpest tool for capacity knees — offered load is exact, so
    goodput shortfall is all queueing."""

    rate_hz: float = 10.0

    kind = "constant"

    def __post_init__(self):
        super().__post_init__()
        if self.rate_hz <= 0:
            raise ValueError("rate_hz must be > 0")

    def _times(self, rng: Random) -> Iterator[float]:
        i = 0
        while True:
            yield i / self.rate_hz   # i/rate, never t += gap: no fp drift
            i += 1


@dataclass(frozen=True)
class PoissonArrivals(ArrivalProcess):
    """Memoryless load at ``rate_hz``: i.i.d. exponential gaps.  The
    canonical open-loop model — bursts and lulls arrive for free, which
    is exactly what makes tail latency honest."""

    rate_hz: float = 10.0

    kind = "poisson"

    def __post_init__(self):
        super().__post_init__()
        if self.rate_hz <= 0:
            raise ValueError("rate_hz must be > 0")

    def _times(self, rng: Random) -> Iterator[float]:
        t = 0.0
        while True:
            t += -math.log(1.0 - rng.random()) / self.rate_hz
            yield t


@dataclass(frozen=True)
class DiurnalArrivals(ArrivalProcess):
    """Sinusoidal ramp between ``base_hz`` and ``peak_hz`` over
    ``period_s`` — the day/night shape that makes autoscalers earn their
    keep.  Implemented by thinning a ``peak_hz`` Poisson stream; each
    candidate always draws two variates (gap, accept) so the stream stays
    ordinal-aligned no matter which candidates survive — the same
    discipline ``ChaosPolicy`` uses for its fault streams."""

    base_hz: float = 5.0
    peak_hz: float = 20.0
    period_s: float = 60.0

    kind = "diurnal"

    def __post_init__(self):
        super().__post_init__()
        if not 0 < self.base_hz <= self.peak_hz:
            raise ValueError("need 0 < base_hz <= peak_hz")
        if self.period_s <= 0:
            raise ValueError("period_s must be > 0")

    def rate_at(self, t: float) -> float:
        """Instantaneous target rate: ``base`` at t=0, ``peak`` mid-period."""
        swing = 0.5 * (1.0 - math.cos(2.0 * math.pi * t / self.period_s))
        return self.base_hz + (self.peak_hz - self.base_hz) * swing

    def _times(self, rng: Random) -> Iterator[float]:
        t = 0.0
        while True:
            t += -math.log(1.0 - rng.random()) / self.peak_hz
            u = rng.random()                      # drawn even if rejected
            if u * self.peak_hz <= self.rate_at(t):
                yield t


@dataclass(frozen=True)
class TraceArrivals(ArrivalProcess):
    """Replay a recorded ``(t, scenario, params)`` arrival log verbatim —
    the bridge from a captured production trace (or a previous run's
    ``ArrivalProcess.trace()``) back into the load generator.  Bounds
    still apply, so a long trace can be replayed truncated."""

    log: Tuple[Arrival, ...] = ()

    kind = "trace"

    def __post_init__(self):
        # a trace is inherently bounded; exempt it from the bound check
        if self.n_requests is None and self.duration_s is None:
            object.__setattr__(self, "n_requests", len(self.log))
        super().__post_init__()
        object.__setattr__(self, "log", tuple(
            a if isinstance(a, Arrival) else Arrival(*a) for a in self.log))
        for prev, cur in zip(self.log, self.log[1:]):
            if cur.t < prev.t:
                raise ValueError(
                    f"trace times must be nondecreasing; got {cur.t} after "
                    f"{prev.t}")

    @classmethod
    def from_log(cls, rows: Iterable) -> "TraceArrivals":
        """Build from plain rows — ``(t, scenario, params_dict)`` triples
        (the JSON-friendly recorded form) or ``Arrival`` instances."""
        log = tuple(a if isinstance(a, Arrival)
                    else Arrival(t=a[0], scenario=a[1],
                                 params=a[2] if len(a) > 2 else ())
                    for a in rows)
        return cls(log=log)

    def to_log(self) -> List[Tuple[float, str, Dict]]:
        """The JSON-friendly recorded form (round-trips via ``from_log``)."""
        return [(a.t, a.scenario, a.kwargs) for a in self.log]

    def _times(self, rng: Random) -> Iterator[float]:  # pragma: no cover
        raise AssertionError("TraceArrivals overrides __iter__")

    def __iter__(self) -> Iterator[Arrival]:
        n = 0
        for a in self.log:
            if self.n_requests is not None and n >= self.n_requests:
                return
            if self.duration_s is not None and a.t > self.duration_s:
                return
            yield a
            n += 1


#: HTTP/CLI-facing registry: ``process=`` query parameter values
ARRIVAL_KINDS = {
    "constant": ConstantArrivals,
    "poisson": PoissonArrivals,
    "diurnal": DiurnalArrivals,
}


def arrival_process(kind: str, scenario: str, *, seed: int = 0,
                    n_requests: Optional[int] = None,
                    duration_s: Optional[float] = None,
                    params: Optional[Dict] = None,
                    **knobs) -> ArrivalProcess:
    """Factory keyed by ``kind`` — the string surface the HTTP endpoint
    and CLI use.  ``knobs`` are the process's own shape parameters
    (``rate_hz``, ``base_hz``/``peak_hz``/``period_s``)."""
    try:
        cls = ARRIVAL_KINDS[kind]
    except KeyError:
        raise ValueError(
            f"unknown arrival process {kind!r}; valid kinds: "
            + ", ".join(sorted(ARRIVAL_KINDS))) from None
    return cls(scenario=scenario, params=_freeze_params(params), seed=seed,
               n_requests=n_requests, duration_s=duration_s, **knobs)

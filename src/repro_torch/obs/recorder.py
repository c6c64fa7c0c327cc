"""Bounded flight recorder of typed, picklable fleet events.

Every party in a fleet — the coordinator, each ``worker_loop``, each
host agent — runs one ``FlightRecorder``.  Events are small frozen
dataclasses stamped on the recording process's monotonic clock
(``obs.clock.now()``); worker/agent buffers ship home as ``ObsFrame``s
piggybacked on result/stop frames and are absorbed onto the
coordinator's timeline after a per-peer ``ClockSync`` rebase.

Determinism contract
--------------------
Event *identity* is ``(scope, kind, ordinal)``: ordinals are 1-based
per-(scope, kind) counters (the same discipline ``ChaosActor`` uses for
its per-scope fault streams), and ``Event.eid`` is a truncated sha256
of that triple.  A seeded chaos run therefore emits a deterministic
event *sequence* — rerunning the same (seed, policy, fleet shape)
yields the same kinds, scopes and ordinals even though every timestamp
differs.  ``event_sequence()`` is the canonical projection tests and CI
compare; wall-driven kinds (heartbeat cadence, respawn readiness,
queue-pressure autoscale, straggler speculation) are excluded from it
because whether and how often they fire depends on machine speed, not
on the seeded schedule.

Truncation is never silent: when the ring is full the oldest event is
dropped and ``dropped_events`` increments, and frames carry their
origin's drop count so the merged timeline can report a total.
"""
from __future__ import annotations

import hashlib
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.obs import clock

#: Event kinds with a stable meaning across the fleet.  The recorder
#: accepts any kind string (plugins may extend), but these are the ones
#: the executor/worker/agent emit and the trace exporter styles.
KINDS = (
    "enqueue",          # coordinator: bundle entered the pending queue
    "dispatch",         # coordinator/worker: bundle handed to a peer
    "requeue",          # coordinator: bundle returned for another attempt
    "done",             # coordinator: bundle's report folded
    "skip",             # coordinator: poison budget spent, hole folded
                        #   (reason="ancestor": cascade hole — a bundle
                        #   this one depends on was skipped, not itself)
    "dep_wait",         # coordinator: bundle admitted but blocked on
                        #   unmet dependency edges (frontier)
    "dep_release",      # coordinator: last unmet parent landed — the
                        #   bundle entered the dispatchable frontier
    "heartbeat",        # any: liveness pulse observed (excluded from seq)
    "scale_up",         # coordinator: pool grew
    "scale_down",       # coordinator: pool shrank (drain or midstream)
    "fault_opened",     # coordinator: a peer died / went silent
    "fault_repaired",   # coordinator: replacement became ready
    "segment_replay",   # worker: one bundle replayed (per-bundle costs)
    "collective_leg",   # worker: bundle carried collective dispatches
    "speculate",        # coordinator: straggler double-dispatched
    "crash_loop",       # coordinator: respawn breaker opened
)

#: Kinds whose occurrence depends on wall time rather than the seeded
#: schedule — heartbeat cadence, whether a respawn warmed before the
#: stream drained, queue-pressure autoscale, straggler quantiles —
#: excluded from the canonical determinism sequence.  (``fault_opened``
#: stays in: chaos kills are dispatch-counted, so deaths are part of
#: the schedule.)
TIMER_KINDS = frozenset({"heartbeat", "fault_repaired", "scale_up",
                         "scale_down", "speculate"})


def _eid(scope: str, kind: str, ordinal: int) -> str:
    h = hashlib.sha256(f"{scope}|{kind}|{ordinal}".encode())
    return h.hexdigest()[:12]


@dataclass(frozen=True)
class Event:
    """One recorded fact.  ``t`` is monotonic in the *recorder's* clock
    domain until absorbed (rebased) onto another timeline."""
    kind: str
    scope: str
    ordinal: int
    t: float
    data: Tuple[Tuple[str, object], ...] = ()
    eid: str = ""

    def get(self, key: str, default=None):
        for k, v in self.data:
            if k == key:
                return v
        return default

    def to_dict(self) -> dict:
        return {"kind": self.kind, "scope": self.scope,
                "ordinal": self.ordinal, "t": self.t, "eid": self.eid,
                "data": dict(self.data)}

    @classmethod
    def from_dict(cls, d: dict) -> "Event":
        return cls(kind=d["kind"], scope=d["scope"], ordinal=d["ordinal"],
                   t=d["t"], data=tuple(sorted(d.get("data", {}).items())),
                   eid=d.get("eid", ""))


@dataclass(frozen=True)
class ObsFrame:
    """A drained buffer in flight: origin scope, its events (origin
    clock domain), how many that origin has dropped so far, and a clock
    echo — ``echo_t`` is the last coordinator-domain stamp the sender
    saw (from a dispatch frame), ``sent_at`` the sender's clock when
    the frame was built.  The receiving side turns the pair plus its
    own arrival stamp into a ``ClockSync`` observation."""
    scope: str
    events: Tuple[Event, ...] = ()
    dropped: int = 0
    echo_t: Optional[float] = None
    sent_at: float = 0.0


class FlightRecorder:
    """Bounded ring buffer of events with deterministic ordinals.

    Not thread-safe by itself; callers that record from multiple
    threads (the executor's collect loop vs. timing callbacks) must
    serialize — in practice every recording site in the fleet already
    runs on one thread per recorder.
    """

    def __init__(self, scope: str, capacity: int = 4096) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.scope = scope
        self.capacity = capacity
        self.dropped_events = 0          # oldest-evicted, never silent
        self._ring: deque = deque()
        self._ordinals: Dict[Tuple[str, str], int] = {}
        #: drop counts reported by absorbed foreign frames, by scope
        self.foreign_dropped: Dict[str, int] = {}
        #: coordinator-domain stamp of the most recent dispatch echo —
        #: workers copy it into the frames they ship home
        self.last_echo: Optional[float] = None

    # -- recording -----------------------------------------------------
    def record(self, kind: str, t: Optional[float] = None,
               scope: Optional[str] = None, **data) -> Event:
        """Append one event; ordinal is the next in this recorder's
        per-(scope, kind) stream."""
        sc = scope if scope is not None else self.scope
        key = (sc, kind)
        ordinal = self._ordinals.get(key, 0) + 1
        self._ordinals[key] = ordinal
        ev = Event(kind=kind, scope=sc, ordinal=ordinal,
                   t=clock.now() if t is None else t,
                   data=tuple(sorted(data.items())),
                   eid=_eid(sc, kind, ordinal))
        self._append(ev)
        return ev

    def _append(self, ev: Event) -> None:
        if len(self._ring) >= self.capacity:
            self._ring.popleft()
            self.dropped_events += 1
        self._ring.append(ev)

    # -- shipping ------------------------------------------------------
    def drain(self, echo_t: Optional[float] = None) -> ObsFrame:
        """Package and clear the buffer for piggybacking on a reply.
        ``dropped`` carries the lifetime drop count (idempotent to
        re-report; receivers keep the max per scope)."""
        frame = ObsFrame(scope=self.scope, events=tuple(self._ring),
                         dropped=self.dropped_events,
                         echo_t=echo_t if echo_t is not None
                         else self.last_echo,
                         sent_at=clock.now())
        self._ring.clear()
        return frame

    def absorb(self, frame: ObsFrame,
               to_local: Optional[Callable[[float], float]] = None) -> None:
        """Merge a foreign frame onto this timeline, rebasing stamps
        through ``to_local`` (a ``ClockSync.to_local`` bound method, or
        identity for same-process sources).  Foreign ordinals are kept:
        they were assigned by the origin recorder under its own scope,
        so they cannot clash with local streams."""
        self.foreign_dropped[frame.scope] = max(
            self.foreign_dropped.get(frame.scope, 0), frame.dropped)
        for ev in frame.events:
            t = to_local(ev.t) if to_local is not None else ev.t
            if t != ev.t:
                ev = Event(kind=ev.kind, scope=ev.scope, ordinal=ev.ordinal,
                           t=t, data=ev.data, eid=ev.eid)
            self._append(ev)

    # -- reading -------------------------------------------------------
    def events(self) -> List[Event]:
        return list(self._ring)

    def __len__(self) -> int:
        return len(self._ring)

    @property
    def total_dropped(self) -> int:
        """Local drops plus every absorbed origin's reported drops."""
        return self.dropped_events + sum(self.foreign_dropped.values())

    def tail(self, n: int) -> List[Event]:
        """Last ``n`` events in arrival order (postmortem dump)."""
        if n <= 0:
            return []
        return list(self._ring)[-n:]

    def snapshot(self, last_n: Optional[int] = None) -> dict:
        """JSON-able view for ``FleetReport.obs``."""
        evs = self.events() if last_n is None else self.tail(last_n)
        return {
            "schema": 1,
            "scope": self.scope,
            "events": [e.to_dict() for e in evs],
            "dropped_events": self.total_dropped,
            "clock": {"anchor_mono": clock.anchor()[0],
                      "anchor_wall": clock.anchor()[1]},
        }


def event_sequence(events: Iterable[Event],
                   exclude: frozenset = TIMER_KINDS
                   ) -> List[Tuple[str, str, int]]:
    """Canonical determinism projection: ``(scope, kind, ordinal)``
    triples, timestamps excluded, timer-driven kinds excluded, sorted —
    two seeded runs of the same fleet must produce identical lists."""
    return sorted((e.scope, e.kind, e.ordinal)
                  for e in events if e.kind not in exclude)

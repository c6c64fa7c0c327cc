"""Chrome trace-event JSON export of a merged fleet timeline.

Perfetto (https://ui.perfetto.dev) and ``chrome://tracing`` both load
the JSON object format: ``{"traceEvents": [...]}`` with microsecond
timestamps.  The mapping here:

* one *process* per fleet run (pid 1), one *thread track* per scope
  (coordinator, ``worker:N``, ``agent``, ...), named via ``"M"``
  metadata events;
* complete spans (``"ph": "X"``) for bundle lifecycle — a ``queue``
  span from enqueue→dispatch on the coordinator track and a ``replay``
  span from dispatch→done/requeue on the serving scope's track (a
  requeued bundle therefore shows *two* dispatch spans, the second on
  its rescue worker);
* instant events (``"ph": "i"``) for faults, scales, skips, crash
  loops;
* flow arrows (``"ph": "s"``/``"f"`` pairs) along dependency edges —
  from a parent bundle's ``done`` on its serving worker's track to the
  child's first subsequent ``dispatch`` on *its* worker's track, so a
  DAG run's fork-join structure is visible as arrows crossing worker
  tracks in Perfetto — and between the legs of one collective
  (``collective_leg`` events sharing a ``group``) across workers, the
  same mechanism linking the spans of a single logical collective;
* counter tracks (``"ph": "C"``) for SLO windows (p50/p99/p999 ms)
  when the caller passes the ``SLOEngine`` report.

Timestamps arrive monotonic (coordinator domain, post-``ClockSync``
rebase); the exporter shifts them so the earliest event is t=0.
"""
from __future__ import annotations

import json
from typing import Dict, Iterable, List, Optional, Sequence

from repro_torch.obs.recorder import Event

_PID = 1
#: stable track (tid) order: coordinator first, then workers/agents
#: in first-appearance order.
_COORD_TID = 0

#: instantaneous kinds and their trace category
_INSTANT_KINDS = {
    "enqueue": "queue", "requeue": "sched", "skip": "sched",
    "scale_up": "scale", "scale_down": "scale",
    "fault_opened": "fault", "fault_repaired": "fault",
    "speculate": "sched", "crash_loop": "fault",
    "heartbeat": "liveness",
    "dep_wait": "dag", "dep_release": "dag",
}


def _us(t: float, t0: float) -> float:
    return round((t - t0) * 1e6, 3)


def to_chrome_trace(events: Sequence[Event],
                    slo_windows: Optional[Sequence[dict]] = None,
                    meta: Optional[dict] = None) -> dict:
    """Render a merged event timeline as a Chrome trace-event object.

    ``slo_windows`` takes ``SLOEngine.report()["windows"]`` (dicts with
    ``t0``/``t1`` wall offsets and ``p50_ms``/``p99_ms``/``p999_ms``)
    and becomes counter tracks.  ``meta`` lands under ``"metadata"``.
    """
    events = sorted(events, key=lambda e: (e.t, e.scope, e.ordinal))
    t0 = events[0].t if events else 0.0
    tids: Dict[str, int] = {}

    def tid(scope: str) -> int:
        if scope not in tids:
            tids[scope] = _COORD_TID if scope == "coordinator" \
                else len(tids) + (0 if "coordinator" in tids else 1)
        return tids[scope]

    out: List[dict] = []
    # -- bundle lifecycle spans ---------------------------------------
    # enqueue -> dispatch (queue span, coordinator track), then per
    # dispatch: dispatch -> next (requeue|done|skip) for the same idx
    # (replay span on the dispatched scope's track).
    by_idx: Dict[int, List[Event]] = {}
    for e in events:
        idx = e.get("idx")
        if idx is not None and e.kind in (
                "enqueue", "dispatch", "requeue", "done", "skip"):
            by_idx.setdefault(idx, []).append(e)
    for idx, evs in by_idx.items():
        pending_enq: Optional[Event] = None
        open_disp: Optional[Event] = None
        for e in evs:
            if e.kind in ("enqueue", "requeue"):
                pending_enq = e
            elif e.kind == "dispatch":
                if pending_enq is not None:
                    out.append({
                        "name": f"queue b{idx}", "cat": "queue",
                        "ph": "X", "pid": _PID, "tid": tid("coordinator"),
                        "ts": _us(pending_enq.t, t0),
                        "dur": _us(e.t, pending_enq.t),
                        "args": {"idx": idx,
                                 "attempt": e.get("attempt", 1)}})
                    pending_enq = None
                open_disp = e
            # a requeue both closes the failed attempt's replay span
            # (above the enqueue/requeue branch re-opened queue wait)
            if e.kind in ("done", "requeue", "skip") and open_disp is not None:
                scope = open_disp.get("peer", open_disp.scope)
                out.append({
                    "name": f"replay b{idx}", "cat": "replay",
                    "ph": "X", "pid": _PID, "tid": tid(str(scope)),
                    "ts": _us(open_disp.t, t0),
                    "dur": _us(e.t, open_disp.t),
                    "args": {"idx": idx, "outcome": e.kind,
                             "attempt": open_disp.get("attempt", 1)}})
                open_disp = None
    # -- dependency flow arrows ---------------------------------------
    # one s/f pair per edge: start at the parent's done (on the track
    # that served it), finish at the child's first dispatch at-or-after
    # it (on the child's serving track) — Perfetto draws the arrow
    # between the two replay spans, making the DAG visible across
    # worker tracks.  bp="e" binds the finish to its enclosing slice.
    flow_id = 0
    done_ev: Dict[int, Event] = {}
    parents_of: Dict[int, Sequence[int]] = {}
    for e in events:
        idx = e.get("idx")
        if idx is None:
            continue
        if e.kind == "done" and idx not in done_ev:
            done_ev[idx] = e
        elif e.kind == "enqueue" and e.get("parents") and \
                idx not in parents_of:
            parents_of[idx] = e.get("parents")
    for idx in sorted(parents_of):
        for p in parents_of[idx]:
            dn = done_ev.get(p)
            if dn is None:
                continue        # parent skipped/unfinished: no arrow
            disp = next((e for e in by_idx.get(idx, ())
                         if e.kind == "dispatch" and e.t >= dn.t),
                        next((e for e in by_idx.get(idx, ())
                              if e.kind == "dispatch"), None))
            if disp is None:
                continue
            flow_id += 1
            out.append({
                "name": "dep", "cat": "dag", "ph": "s", "id": flow_id,
                "pid": _PID, "tid": tid(str(dn.get("peer", dn.scope))),
                "ts": _us(dn.t, t0), "args": {"parent": p, "child": idx}})
            out.append({
                "name": "dep", "cat": "dag", "ph": "f", "bp": "e",
                "id": flow_id, "pid": _PID,
                "tid": tid(str(disp.get("peer", disp.scope))),
                "ts": _us(max(disp.t, dn.t), t0),
                "args": {"parent": p, "child": idx}})
    # -- collective span links ----------------------------------------
    # legs of one logical collective share a ``group`` tag; chain them
    # in time order with the same flow mechanism so the legs a single
    # collective lands on different workers read as one linked operation
    groups: Dict[str, List[Event]] = {}
    for e in events:
        if e.kind == "collective_leg" and e.get("group") is not None:
            groups.setdefault(str(e.get("group")), []).append(e)
    for g in sorted(groups):
        legs = sorted(groups[g], key=lambda e: (e.t, e.scope, e.ordinal))
        if len(legs) < 2 or len({e.scope for e in legs}) < 2:
            continue            # one worker's legs already share a track
        for a, b in zip(legs, legs[1:]):
            flow_id += 1
            out.append({
                "name": "collective_link", "cat": "collective",
                "ph": "s", "id": flow_id, "pid": _PID,
                "tid": tid(a.scope), "ts": _us(a.t, t0),
                "args": {"group": g}})
            out.append({
                "name": "collective_link", "cat": "collective",
                "ph": "f", "bp": "e", "id": flow_id, "pid": _PID,
                "tid": tid(b.scope), "ts": _us(max(b.t, a.t), t0),
                "args": {"group": g}})
    # -- worker-side spans and instants -------------------------------
    for e in events:
        if e.kind == "segment_replay":
            dur = float(e.get("ttc_s", 0.0) or 0.0)
            out.append({
                "name": f"segments b{e.get('idx', '?')}", "cat": "worker",
                "ph": "X", "pid": _PID, "tid": tid(e.scope),
                "ts": _us(e.t - dur, t0), "dur": _us(e.t, e.t - dur),
                "args": dict(e.data)})
        elif e.kind == "collective_leg":
            out.append({
                "name": "collective", "cat": "worker", "ph": "i",
                "s": "t", "pid": _PID, "tid": tid(e.scope),
                "ts": _us(e.t, t0), "args": dict(e.data)})
        elif e.kind in _INSTANT_KINDS:
            out.append({
                "name": e.kind, "cat": _INSTANT_KINDS[e.kind], "ph": "i",
                "s": "g" if e.kind.startswith(("fault", "scale", "crash"))
                else "t",
                "pid": _PID, "tid": tid(e.scope), "ts": _us(e.t, t0),
                "args": dict(e.data)})
    # -- SLO counter tracks -------------------------------------------
    for w in slo_windows or []:
        ts = _us(float(w.get("t0", 0.0)), 0.0)
        args = {k: float(w[k]) for k in ("p50_ms", "p99_ms", "p999_ms")
                if w.get(k) is not None}
        if args:
            out.append({"name": "slo_latency_ms", "cat": "slo", "ph": "C",
                        "pid": _PID, "tid": 0, "ts": ts, "args": args})
    # -- track naming metadata ----------------------------------------
    for scope, t in sorted(tids.items(), key=lambda kv: kv[1]):
        out.append({"name": "thread_name", "ph": "M", "pid": _PID,
                    "tid": t, "args": {"name": scope}})
    out.append({"name": "process_name", "ph": "M", "pid": _PID, "tid": 0,
                "args": {"name": "repro fleet"}})
    trace = {"traceEvents": out, "displayTimeUnit": "ms"}
    if meta:
        trace["metadata"] = meta
    return trace


def slo_windows_ms(slo_report: dict) -> List[dict]:
    """``SLOEngine.report()`` → counter-track window dicts.

    The engine reports window quantiles in seconds; the counter track
    renders milliseconds (the unit the SLO itself is declared in)."""
    out = []
    for w in slo_report.get("windows", ()):
        out.append({"t0": float(w.get("t0", 0.0)),
                    "p50_ms": 1e3 * float(w.get("p50", 0.0)),
                    "p99_ms": 1e3 * float(w.get("p99", 0.0)),
                    "p999_ms": 1e3 * float(w.get("p999", 0.0))})
    return out


_REQUIRED = {"X": ("name", "ph", "pid", "tid", "ts", "dur"),
             "i": ("name", "ph", "pid", "tid", "ts"),
             "C": ("name", "ph", "pid", "ts", "args"),
             "M": ("name", "ph", "pid", "args"),
             # flow arrows: start / finish (finish also carries bp="e")
             "s": ("name", "cat", "id", "pid", "tid", "ts"),
             "f": ("name", "cat", "id", "pid", "tid", "ts")}


def validate_trace(trace: dict) -> None:
    """Strict structural check of a trace-event object (the schema
    Perfetto's JSON importer requires).  Raises ``ValueError`` on the
    first violation; returning means loadable."""
    if not isinstance(trace, dict) or "traceEvents" not in trace:
        raise ValueError("trace must be an object with 'traceEvents'")
    evs = trace["traceEvents"]
    if not isinstance(evs, list):
        raise ValueError("'traceEvents' must be a list")
    for i, e in enumerate(evs):
        if not isinstance(e, dict):
            raise ValueError(f"traceEvents[{i}] is not an object")
        ph = e.get("ph")
        if ph not in _REQUIRED:
            raise ValueError(f"traceEvents[{i}]: unsupported ph {ph!r}")
        for k in _REQUIRED[ph]:
            if k not in e:
                raise ValueError(f"traceEvents[{i}] (ph={ph}): missing {k!r}")
        for k in ("ts", "dur"):
            if k in e:
                v = e[k]
                if not isinstance(v, (int, float)):
                    raise ValueError(
                        f"traceEvents[{i}]: {k} must be a number, got "
                        f"{type(v).__name__}")
                if k == "dur" and v < 0:
                    raise ValueError(f"traceEvents[{i}]: negative dur {v}")
        if ph == "i" and e.get("s", "t") not in ("t", "p", "g"):
            raise ValueError(f"traceEvents[{i}]: bad instant scope "
                             f"{e.get('s')!r}")
    json.dumps(trace)   # must be serializable as-is


def write_trace(path: str, trace: dict) -> str:
    """Validate then write a trace file Perfetto can open directly."""
    validate_trace(trace)
    with open(path, "w") as f:
        json.dump(trace, f, separators=(",", ":"))
    return path

"""The service's HTTP surface: start/query/stop load runs over stdlib
``http.server``, SLO reports as JSON.

In the spirit of the synthetic-agents harness's ``/run?scenario=fanout&
fanout=100`` endpoints: every knob is a query parameter, so a perf PR
gets a traffic-shaped benchmark from a one-line ``curl`` instead of a
fixed profile list.

Routes (all GET, all JSON):

* ``/healthz`` — liveness probe.
* ``/scenarios`` — the registered scenario generators and their params.
* ``/run?scenario=serving_traffic&process=poisson&rate_hz=20&n=100`` —
  start a load run; returns ``{"id": ...}`` immediately, or the full
  report when ``wait=1``.  Scenario params are passed ``p_``-prefixed
  (``p_fanout=100``); chaos via ``kill_every=``/``chaos_seed=``; pool
  shape via ``workers=``/``autoscale=``/``min_workers=``; the objective
  via ``slo_ms=``/``slo_pct=``.
* ``/status?id=N`` — run state; includes the SLO report once finished.
* ``/stop?id=N`` — stop admitting arrivals; the queue still drains and
  the truncated run reports normally.
* ``/runs`` — all runs this service has seen (schema-tagged
  ``FleetReport.to_json`` payloads, not ad-hoc dicts).
* ``/trace?id=N`` — the finished run's merged flight-recorder timeline
  as Chrome trace-event JSON (load it at https://ui.perfetto.dev); a
  finished ``/run``/``/status`` response links here.
* ``/metrics`` — Prometheus text exposition (the one non-JSON route):
  service-level run/request counters plus the request-latency
  histogram folded from every finished run's SLO sketch.

Run it: ``python -m repro_torch.service [--port 8787]`` (or
``python -m repro_torch.scenarios serve``).
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional
from urllib.parse import parse_qsl, urlparse

from repro_torch.core.emulator import Emulator
from repro_torch.fleet.chaos import ChaosPolicy
from repro_torch.fleet.config import FleetConfig
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.recorder import Event
from repro_torch.obs.trace import slo_windows_ms, to_chrome_trace
from repro_torch.service.arrivals import ARRIVAL_KINDS, arrival_process
from repro_torch.service.load import LoadReport, run_load
from repro_torch.service.slo import SLO

#: one serve "session" (a run) may sit queued behind chaos recovery for
#: a while; the stream deadline is a backstop, not a feature here
_RUN_TIMEOUT_S = 24 * 3600.0


def _coerce(v: str):
    """Query-string value → int/float/bool/str, best effort."""
    low = v.lower()
    if low in ("true", "yes", "on"):
        return True
    if low in ("false", "no", "off"):
        return False
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            continue
    return v


class LoadRunHandle:
    """One load run's lifetime: a driver thread around ``run_load``."""

    def __init__(self, run_id: int, spec: Dict, thread: threading.Thread,
                 stop: threading.Event):
        self.run_id = run_id
        self.spec = spec
        self.thread = thread
        self.stop_event = stop
        self.report: Optional[LoadReport] = None
        self.error: Optional[str] = None

    @property
    def state(self) -> str:
        if self.thread.is_alive():
            return "stopping" if self.stop_event.is_set() else "running"
        return "failed" if self.error is not None else "done"

    def describe(self, full: bool = False) -> Dict:
        out = {"id": self.run_id, "state": self.state, "spec": self.spec}
        if self.error is not None:
            out["error"] = self.error
        if self.report is not None and (full or not self.thread.is_alive()):
            out["report"] = self.report.to_dict()
            out["trace"] = f"/trace?id={self.run_id}"
        return out


class LoadService:
    """Run registry + parameter parsing; the handler below is a thin
    shim over this so it is testable without sockets.  Each run's workers
    replay on ``emulator``'s device; the default ``Emulator()`` runs on
    ``"cuda"`` and raises where there is no card."""

    def __init__(self, emulator: Optional[Emulator] = None):
        self._em = emulator if emulator is not None else Emulator()
        self._runs: Dict[int, LoadRunHandle] = {}
        self._next_id = 1
        self._lock = threading.Lock()
        # the /metrics scrape body: service-level series here; per-run
        # fleet series live in each report's obs snapshot
        self.metrics = MetricsRegistry()
        self._m_runs = self.metrics.counter(
            "repro_service_runs_total", "load runs by terminal state")
        self._m_active = self.metrics.gauge(
            "repro_service_runs_active", "driver threads currently running")
        self._m_requests = self.metrics.counter(
            "repro_service_requests_total",
            "requests across finished runs, by outcome")
        self._m_latency = self.metrics.histogram(
            "repro_service_request_latency_seconds",
            "open-loop request latency across finished runs")

    # -- query parsing ------------------------------------------------------

    def _parse(self, q: Dict) -> Dict:
        scenario = str(q.get("scenario", "serving_traffic"))
        kind = str(q.get("process", "poisson"))
        if kind not in ARRIVAL_KINDS:
            raise ValueError(f"unknown arrival process {kind!r}; valid: "
                             + ", ".join(sorted(ARRIVAL_KINDS)))
        params = {k[2:]: v for k, v in q.items() if k.startswith("p_")}
        knobs = {}
        for name in ("rate_hz", "base_hz", "peak_hz", "period_s"):
            if name in q:
                knobs[name] = float(q[name])
        if "rate" in q:                      # ergonomic alias
            knobs.setdefault("rate_hz", float(q["rate"]))
        if kind != "diurnal":
            knobs.pop("base_hz", None)
            knobs.pop("peak_hz", None)
            knobs.pop("period_s", None)
        n_requests = q.get("n", q.get("n_requests"))
        duration_s = q.get("duration", q.get("duration_s"))
        if n_requests is None and duration_s is None:
            n_requests = 50
        chaos = None
        chaos_knobs = {k: int(q[k]) for k in ("kill_every", "hang_nth",
                                              "fail_nth", "delay_every",
                                              "max_faults") if k in q}
        if chaos_knobs:
            chaos = ChaosPolicy(seed=int(q.get("chaos_seed", 0)),
                                **chaos_knobs)
        workers = int(q.get("workers", 2))
        autoscale = bool(q.get("autoscale", False))
        liveness = q.get("liveness", q.get("liveness_timeout"))
        if liveness is None and chaos is not None:
            liveness = 5.0                   # chaos without liveness is deaf
        config = FleetConfig.process(
            max_workers=workers, autoscale=autoscale,
            min_workers=int(q["min_workers"]) if autoscale
            and "min_workers" in q else None,
            liveness_timeout=float(liveness) if liveness is not None
            else None,
            on_failure="skip",               # a poison request must not
            chaos=chaos,                     # take the service down
            max_respawns=int(q.get("max_respawns", max(8, workers * 4))),
            timeout=float(q.get("timeout", _RUN_TIMEOUT_S)))
        return {
            "scenario": scenario, "kind": kind, "params": params,
            "knobs": knobs, "seed": int(q.get("seed", 0)),
            "n_requests": int(n_requests) if n_requests is not None
            else None,
            "duration_s": float(duration_s) if duration_s is not None
            else None,
            "config": config,
            "slo": SLO(target_ms=float(q.get("slo_ms", 200.0)),
                       percentile=float(q.get("slo_pct", 0.99))),
            "window_s": float(q.get("window_s", 1.0)),
            "time_scale": float(q.get("time_scale", 1.0)),
        }

    # -- verbs --------------------------------------------------------------

    def start(self, q: Dict, wait: bool = False) -> Dict:
        spec = self._parse(q)
        arrivals = arrival_process(
            spec["kind"], spec["scenario"], seed=spec["seed"],
            n_requests=spec["n_requests"], duration_s=spec["duration_s"],
            params=spec["params"], **spec["knobs"])
        stop = threading.Event()
        with self._lock:
            run_id = self._next_id
            self._next_id += 1

        def drive():
            self._m_active.inc(1)
            try:
                report = run_load(
                    self._em, arrivals, config=spec["config"],
                    slo=spec["slo"], window_s=spec["window_s"],
                    time_scale=spec["time_scale"], stop=stop)
                handle.report = report
                self._m_runs.inc(state="done")
                self._m_requests.inc(report.serve.n_ok, outcome="ok")
                self._m_requests.inc(report.serve.n_skipped,
                                     outcome="skipped")
                if report.latency is not None and report.latency.count:
                    self._m_latency.absorb(report.latency)
            except BaseException as e:  # noqa: BLE001 — reported via /status
                handle.error = f"{type(e).__name__}: {e}"
                self._m_runs.inc(state="failed")
            finally:
                self._m_active.inc(-1)

        public = {k: (repr(v) if k in ("config", "slo") else v)
                  for k, v in spec.items()}
        thread = threading.Thread(target=drive, name=f"load-run-{run_id}",
                                  daemon=True)
        handle = LoadRunHandle(run_id, public, thread, stop)
        with self._lock:
            self._runs[run_id] = handle
        thread.start()
        if wait:
            thread.join()
        return handle.describe()

    def _handle(self, run_id) -> LoadRunHandle:
        try:
            return self._runs[int(run_id)]
        except (KeyError, TypeError, ValueError):
            raise KeyError(f"unknown run id {run_id!r}") from None

    def status(self, run_id) -> Dict:
        return self._handle(run_id).describe()

    def stop(self, run_id) -> Dict:
        h = self._handle(run_id)
        h.stop_event.set()
        return h.describe()

    def runs(self) -> Dict:
        with self._lock:
            return {"runs": [h.describe() for h in self._runs.values()]}

    def trace(self, run_id) -> Dict:
        """A finished run's merged event timeline as a Chrome trace-event
        object (Perfetto-loadable as-is), SLO windows as counter tracks."""
        h = self._handle(run_id)
        if h.report is None:
            raise ValueError(f"run {run_id} has no report yet "
                             f"(state {h.state!r})")
        obs = h.report.serve.obs or {}
        events = [Event.from_dict(d) for d in obs.get("events", ())]
        return to_chrome_trace(
            events, slo_windows=slo_windows_ms(h.report.slo),
            meta={"run_id": h.run_id, "spec": h.spec,
                  "dropped_events": obs.get("dropped_events", 0)})

    def shutdown(self, timeout: float = 30.0):
        """Stop every live run and wait for their driver threads."""
        with self._lock:
            handles = list(self._runs.values())
        for h in handles:
            h.stop_event.set()
        for h in handles:
            h.thread.join(timeout)

    # -- request routing (shared by the socket server and tests) ------------

    def route(self, path: str) -> Dict:
        """Dispatch one request path; returns the JSON-ready response.
        Raises KeyError (404) or ValueError (400) for bad requests."""
        parsed = urlparse(path)
        q = {k: _coerce(v) for k, v in parse_qsl(parsed.query)}
        route = parsed.path.rstrip("/") or "/"
        if route == "/healthz":
            return {"ok": True}
        if route == "/scenarios":
            from repro_torch.scenarios import get_scenario, list_scenarios
            return {"scenarios": {
                name: {"description": get_scenario(name).description,
                       "params": get_scenario(name).defaults}
                for name in list_scenarios()},
                "processes": sorted(ARRIVAL_KINDS)}
        if route == "/run":
            return self.start(q, wait=bool(q.pop("wait", False)))
        if route == "/status":
            return self.status(q.get("id"))
        if route == "/stop":
            return self.stop(q.get("id"))
        if route == "/runs":
            return self.runs()
        if route == "/trace":
            return self.trace(q.get("id"))
        raise KeyError(f"no route {route!r}")


def make_server(host: str = "127.0.0.1", port: int = 8787,
                emulator: Optional[Emulator] = None,
                ) -> ThreadingHTTPServer:
    """Build (but don't start) the HTTP server; ``server.service`` is the
    underlying :class:`LoadService`.  Port 0 picks a free port —
    ``server.server_address`` has the real one."""
    service = LoadService(emulator)

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler contract
            if urlparse(self.path).path.rstrip("/") == "/metrics":
                # the one non-JSON route: Prometheus text exposition
                payload = service.metrics.render().encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)
                return
            try:
                body, code = service.route(self.path), 200
            except KeyError as e:
                body, code = {"error": str(e)}, 404
            except (ValueError, TypeError) as e:
                body, code = {"error": str(e)}, 400
            except Exception as e:  # noqa: BLE001
                body, code = {"error": f"{type(e).__name__}: {e}"}, 500
            payload = json.dumps(body, indent=1, default=str).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def log_message(self, fmt, *args):  # quiet: we're a test target
            pass

    server = ThreadingHTTPServer((host, port), Handler)
    server.service = service
    return server


def serve(host: str = "127.0.0.1", port: int = 8787,
          emulator: Optional[Emulator] = None) -> None:
    """Blocking entrypoint: serve until interrupted."""
    server = make_server(host, port, emulator)
    h, p = server.server_address[:2]
    print(f"repro_torch.service listening on http://{h}:{p}  "
          f"(try /healthz, /scenarios, /run?scenario=serving_traffic"
          f"&process=poisson&rate_hz=20&n=50&wait=1)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.service.shutdown()
        server.server_close()

"""Service observability demo on PyTorch: /metrics scrape + /trace export.

Starts ``repro_torch.service`` on a port-0 HTTP server whose workers
replay on a CUDA card by default, drives one seeded chaos load run
through ``/run``, then exercises the two observability surfaces end to
end:

* ``/trace?id=N``: the run's merged flight-recorder timeline as Chrome
  trace-event JSON, checked against the Perfetto schema;
* ``/metrics``: Prometheus text exposition format 0.0.4, re-read with
  the strict parser (cumulative buckets, ``+Inf``/``_count`` match).

    PYTHONPATH=src python examples/torch_metrics_demo.py [--device cuda|cpu]

Every check here is a contract: a failed one exits non-zero.
"""
import argparse
import json
import os
import sys
import threading
import time
import urllib.request

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(_ROOT, 'src'), _ROOT]

from repro_torch.core import Emulator
from repro_torch.device import cli_device
from repro_torch.obs.metrics import parse_promtext
from repro_torch.obs.trace import validate_trace
from repro_torch.service.http import make_server


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=30) as r:
        body = r.read()
        ctype = r.headers.get("Content-Type", "")
    return body, ctype


def _get_json(base, path):
    body, _ = _get(base, path)
    return json.loads(body)


def check(ok, what):
    if not ok:
        raise SystemExit(f"torch_metrics_demo: {what}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the service's workers replay (default: cuda)")
    args = ap.parse_args()
    em = Emulator(device=cli_device(args.device, "torch_metrics_demo"))
    server = make_server(port=0, emulator=em)    # port 0: pick a free one
    host, port = server.server_address[:2]
    base = f"http://{host}:{port}"
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    print(f"serving on {base}")

    try:
        run = _get_json(base, "/run?scenario=serving_traffic&p_n_requests=3"
                        "&process=poisson&rate_hz=20&n=12&seed=11"
                        "&workers=2&kill_every=5&max_faults=1&chaos_seed=3"
                        "&slo_ms=100&window_s=0.5")
        rid = run["id"]
        print(f"started run {rid}")
        deadline = time.monotonic() + 180
        while True:
            st = _get_json(base, f"/status?id={rid}")
            if st["state"] in ("done", "failed"):
                break
            check(time.monotonic() < deadline, "run did not finish")
            time.sleep(0.5)
        check(st["state"] == "done", st.get("error"))
        report = st["report"]
        check(report["schema"] == 1 and report["fleet"]["schema"] == 1,
              "report schema")
        check(report["n_ok"] >= 1, "no request completed")
        check(st["trace"] == f"/trace?id={rid}", "trace link")
        print(f"run done: {report['n_ok']} ok, "
              f"{report['fleet']['recovery'].get('worker_deaths', 0)} "
              "worker death(s)")

        trace = _get_json(base, st["trace"])
        validate_trace(trace)
        n_spans = sum(1 for e in trace["traceEvents"] if e.get("ph") == "X")
        check(n_spans > 0, "trace must carry bundle spans")
        print(f"trace: {len(trace['traceEvents'])} events "
              f"({n_spans} spans) — Perfetto-schema valid")

        body, ctype = _get(base, "/metrics")
        check(ctype.startswith("text/plain"), ctype)
        fams = parse_promtext(body.decode())     # strict: raises on any
        samples = fams["repro_service_runs_total"]["samples"]
        check(samples[("repro_service_runs_total",
                       '{state="done"}')] == 1.0, "runs_total")
        req = fams["repro_service_requests_total"]["samples"]
        check(req[("repro_service_requests_total",
                   '{outcome="ok"}')] >= 1.0, "requests_total")
        lat = fams["repro_service_request_latency_seconds"]["samples"]
        check(lat[("repro_service_request_latency_seconds_count",
                   "")] >= 1.0, "latency count")
        check(fams["repro_service_runs_active"]["samples"][
            ("repro_service_runs_active", "")] == 0.0, "runs_active")
        print(f"metrics: {len(fams)} families, strict parse ok")
    finally:
        server.shutdown()
    print("OK")


if __name__ == "__main__":
    main()

"""Flight recorder and metrics layer of the port's fleet.

``clock``
    One clock domain for every stamp: a monotonic base with a wall
    anchor (``now()``/``wall()``), plus ``ClockSync``, a per-peer offset
    estimator that rebases worker timestamps onto the coordinator's
    timeline.

``recorder``
    ``FlightRecorder``: a bounded ring buffer of typed, picklable
    ``Event``s (dispatch, requeue, heartbeat, scale_up/down,
    fault_opened/repaired, segment_replay, ...) with sha256-scoped
    per-(scope, kind) ordinals, so a seeded chaos run emits a
    deterministic event *sequence*.  The coordinator and every
    ``worker_loop`` run one; worker buffers ship home piggybacked on
    results as ``ObsFrame``s.

``metrics``
    A small Prometheus text-format registry (counters, gauges and
    histograms backed by ``repro_torch.service.slo.LatencySketch``),
    snapshotted into ``FleetReport.obs``.

The Perfetto trace exporter (``trace`` in the JAX package) is not ported
yet.  Nothing here touches a device.
"""
from repro_torch.obs.clock import ClockSync, anchor, now, wall
from repro_torch.obs.metrics import MetricsRegistry, parse_promtext
from repro_torch.obs.recorder import Event, FlightRecorder, ObsFrame

__all__ = [
    "ClockSync", "anchor", "now", "wall",
    "Event", "FlightRecorder", "ObsFrame",
    "MetricsRegistry", "parse_promtext",
]

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

``trace``
    Chrome trace-event JSON export (Perfetto-loadable): one track per
    worker or agent, spans from ``BundleTiming`` enqueue→dispatch→done,
    instant events for faults and scales, SLO windows as counter tracks.
    For the same events it builds the same trace as the JAX package.

``spans``
    The program's own spans and counters inside the emulator, the
    segment runner and the serving engine, stamped on the device trace's
    clock (``clock.epoch_ns()``) and recorded while ``torch.profiler``
    records or inside ``spans.recording()``; with the segment kernel's
    row times.

Nothing here touches a device.
"""
from repro_torch.obs import spans
from repro_torch.obs.clock import ClockSync, anchor, epoch_ns, now, wall
from repro_torch.obs.metrics import MetricsRegistry, parse_promtext
from repro_torch.obs.recorder import Event, FlightRecorder, ObsFrame
from repro_torch.obs.trace import (slo_windows_ms, to_chrome_trace,
                                   validate_trace, write_trace)

__all__ = [
    "ClockSync", "anchor", "epoch_ns", "now", "wall", "spans",
    "Event", "FlightRecorder", "ObsFrame",
    "slo_windows_ms", "to_chrome_trace", "validate_trace", "write_trace",
    "MetricsRegistry", "parse_promtext",
]

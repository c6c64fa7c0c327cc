"""The port's obs layer (recorder, metrics) and the SLO sketch under it,
against the JAX package's.

The same calls must give the same Prometheus text, the same parsed
families, the same sketch quantiles and the same event identities (ids,
ordinals, the determinism projection) in both packages: exact equality,
since all of it is host arithmetic on the same floats.
"""
import json
import pickle

import numpy as np
import pytest

import repro.obs as RO
import repro_torch.obs as TO
from repro.obs.recorder import event_sequence as r_sequence
from repro.service import slo as rslo
from repro_torch.obs.recorder import event_sequence as t_sequence
from repro_torch.service import slo as tslo


def _fill(obs):
    reg = obs.MetricsRegistry()
    runs = reg.counter("synapse_runs_total", "runs by state")
    runs.inc(state="done")
    runs.inc(2, state="failed")
    active = reg.gauge("synapse_active", "in flight")
    active.set(3)
    active.inc(-0.5, pool="b")
    lat = reg.histogram("synapse_latency_seconds", "request latency")
    rng = np.random.default_rng(7)
    for v in rng.lognormal(-4.0, 2.0, size=200):
        lat.observe(float(v), route="a" if v < 0.02 else "b")
    return reg


def test_metrics_text_and_parse_equal_reference():
    t, r = _fill(TO), _fill(RO)
    text = t.render()
    assert text == r.render()
    assert TO.parse_promtext(text) == RO.parse_promtext(text)
    assert t.snapshot() == r.snapshot()
    fams = TO.parse_promtext(text)
    assert fams["synapse_runs_total"]["type"] == "counter"
    assert fams["synapse_latency_seconds"]["type"] == "histogram"


@pytest.mark.parametrize("bad", [
    "orphan_metric 1\n",
    "# TYPE m counter\nm\n",
    "# TYPE m counter\nm{x=} 1\n",
    "# TYPE m rate\n",
    '# TYPE h histogram\nh_bucket{le="1"} 5\nh_bucket{le="+Inf"} 3\n'
    "h_sum 1\nh_count 3\n",
])
def test_parse_promtext_rejects_like_reference(bad):
    with pytest.raises(ValueError) as te:
        TO.parse_promtext(bad)
    with pytest.raises(ValueError) as re_:
        RO.parse_promtext(bad)
    assert str(te.value) == str(re_.value)


def test_latency_sketch_and_slo_engine_equal_reference():
    rng = np.random.default_rng(3)
    lat = rng.lognormal(-3.0, 1.5, size=500)
    sketches = []
    for mod in (tslo, rslo):
        a, b = mod.LatencySketch(), mod.LatencySketch()
        for i, v in enumerate(lat):
            (a if i % 2 else b).add(float(v))
        m = a.merge(b)
        eng = mod.SLOEngine(mod.SLO(200.0, 0.99), window_s=0.5)
        for i, v in enumerate(lat):
            eng.offered(0.01 * i)
            eng.observe(0.01 * i + float(v), float(v))
        eng.fault(1.0, 1.6)
        sketches.append(([m.quantile(q) for q in (0.5, 0.9, 0.99, 0.999)],
                         m.count, m.mean, eng.report()))
    assert sketches[0] == sketches[1]


def _record(obs):
    rec = obs.FlightRecorder("coordinator", capacity=8)
    for i in range(5):
        rec.record("dispatch", t=0.1 * i, idx=i, peer=f"worker:{i % 2}")
    rec.record("requeue", t=0.6, idx=3, reason="died")
    worker = obs.FlightRecorder("worker:1")
    worker.record("segment_replay", t=100.0, idx=3, ttc_s=0.25)
    sync = obs.ClockSync()
    sync.observe(1.0, 101.0, 1.2)
    rec.absorb(worker.drain(echo_t=1.0), to_local=sync.to_local)
    for i in range(5):
        rec.record("done", t=1.0 + 0.1 * i, idx=i)
    return rec


def test_recorder_events_equal_reference():
    t, r = _record(TO), _record(RO)
    assert [e.to_dict() for e in t.events()] == \
        [e.to_dict() for e in r.events()]
    assert t_sequence(t.events()) == r_sequence(r.events())
    # the snapshots differ only in each module's clock anchor
    ts, rs = t.snapshot(), r.snapshot()
    assert ts.pop("clock").keys() == rs.pop("clock").keys()
    assert ts == rs
    assert (t.dropped_events, t.total_dropped) == \
        (r.dropped_events, r.total_dropped)
    # an event written by either package reads back in the other
    for ev in r.events():
        back = TO.Event.from_dict(json.loads(json.dumps(ev.to_dict())))
        assert back.to_dict() == ev.to_dict()
    frame = pickle.loads(pickle.dumps(t.drain()))
    assert frame.scope == "coordinator" and len(frame.events) == 8

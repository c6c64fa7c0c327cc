"""The port's Perfetto trace export against the JAX package's.

The same events, built through each package's ``FlightRecorder`` from
seeded stamps, must give the same Chrome trace-event object (exact
equality: it is host arithmetic on the same floats); each package's
``validate_trace`` accepts the other's traces and both reject the same
malformed ones; ``write_trace`` round-trips.
"""
import json

import numpy as np
import pytest

import repro.obs as RO
import repro_torch.obs as TO

PKG = {"torch": TO, "jax": RO}


def _storm(obs, rng):
    """Bundle 0 sails through; bundle 1 is dispatched to worker:0, the
    worker dies mid-replay, the bundle is requeued and rescued by
    worker:1 (the JAX package's own storm fixture, at seeded times)."""
    t = np.cumsum(rng.uniform(0.01, 0.2, size=12)).tolist()
    rec = obs.FlightRecorder("coordinator")
    rec.record("enqueue", t=t[0], idx=0)
    rec.record("dispatch", t=t[1], idx=0, peer="worker:0", attempt=1)
    rec.record("enqueue", t=t[2], idx=1)
    rec.record("dispatch", t=t[3], idx=1, peer="worker:0", attempt=1)
    rec.record("done", t=t[4], idx=0)
    rec.record("fault_opened", t=t[5], scope="worker:0")
    rec.record("requeue", t=t[5], idx=1, reason="died")
    rec.record("fault_repaired", t=t[6], scope="worker:0",
               mttr_s=t[6] - t[5])
    rec.record("scale_up", t=t[7], peer="worker:2")
    rec.record("dispatch", t=t[8], idx=1, peer="worker:1", attempt=2)
    rec.record("segment_replay", t=t[9], scope="worker:1", idx=1,
               ttc_s=t[9] - t[8])
    rec.record("heartbeat", t=t[9], scope="worker:1")
    rec.record("done", t=t[10], idx=1)
    rec.record("crash_loop", t=t[11], deaths=3)
    return rec.events()


def _dag(obs, rng):
    """A diamond: 0 feeds 1 and 2 on other workers, both feed 3; node 2
    is skipped, so its edge into 3 draws no arrow."""
    t = np.cumsum(rng.uniform(0.01, 0.2, size=14)).tolist()
    rec = obs.FlightRecorder("coordinator")
    rec.record("enqueue", t=t[0], idx=0)
    rec.record("dispatch", t=t[1], idx=0, peer="worker:0", attempt=1)
    rec.record("done", t=t[2], idx=0, peer="worker:0")
    for i, w in ((1, 0), (2, 1)):
        rec.record("enqueue", t=t[2 + i], idx=i, parents=[0])
        rec.record("dep_release", t=t[2 + i], idx=i, parent=0)
        rec.record("dispatch", t=t[4 + i], idx=i, peer=f"worker:{w}",
                   attempt=1)
    rec.record("done", t=t[7], idx=1, peer="worker:0")
    rec.record("skip", t=t[8], idx=2, reason="poison")
    rec.record("enqueue", t=t[9], idx=3, parents=[1, 2])
    rec.record("dep_wait", t=t[9], idx=3, unmet=[1, 2])
    rec.record("dispatch", t=t[10], idx=3, peer="worker:1", attempt=1)
    rec.record("speculate", t=t[11], idx=3, peer="worker:0")
    rec.record("done", t=t[12], idx=3, peer="worker:1")
    rec.record("scale_down", t=t[13], peer="worker:1")
    return rec.events()


def _collectives(obs, rng):
    """Legs of one collective on two workers are linked; a group on one
    worker and an ungrouped leg are not."""
    t = np.cumsum(rng.uniform(0.01, 0.2, size=5)).tolist()
    rec = obs.FlightRecorder("coordinator")
    rec.record("collective_leg", t=t[0], scope="worker:0", idx=0, n=2,
               group="allreduce:7")
    rec.record("collective_leg", t=t[1], scope="worker:1", idx=1, n=2,
               group="allreduce:7")
    rec.record("collective_leg", t=t[2], scope="worker:0", idx=2, n=1)
    rec.record("collective_leg", t=t[3], scope="worker:1", idx=3,
               group="g")
    rec.record("collective_leg", t=t[4], scope="worker:1", idx=4,
               group="g")
    return rec.events()


SHAPES = {"storm": _storm, "dag": _dag, "collectives": _collectives}


def _windows(rng):
    n = 4
    p50 = rng.uniform(0.001, 0.05, size=n)
    return {"windows": [
        {"t0": 0.5 * i, "p50": float(p50[i]), "p99": float(2 * p50[i]),
         "p999": float(3 * p50[i])} for i in range(n)]}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_trace_equals_reference(shape, seed):
    traces = {}
    for pkg, obs in PKG.items():
        rng = np.random.default_rng(seed)
        events = SHAPES[shape](obs, rng)
        windows = obs.slo_windows_ms(_windows(rng))
        traces[pkg] = obs.to_chrome_trace(events, slo_windows=windows,
                                          meta={"seed": seed})
    assert traces["torch"] == traces["jax"]
    assert json.dumps(traces["torch"]) == json.dumps(traces["jax"])
    phases = {e["ph"] for e in traces["torch"]["traceEvents"]}
    assert {"M", "C"} <= phases
    if shape != "collectives":
        assert "X" in phases


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_slo_windows_equal_reference(seed):
    rep = _windows(np.random.default_rng(seed))
    assert TO.slo_windows_ms(rep) == RO.slo_windows_ms(rep)
    assert TO.slo_windows_ms({}) == RO.slo_windows_ms({}) == []


@pytest.mark.parametrize("maker,checker", [("torch", "jax"),
                                           ("jax", "torch")])
def test_each_validator_accepts_the_others_traces(maker, checker):
    rng = np.random.default_rng(5)
    obs = PKG[maker]
    for build in SHAPES.values():
        trace = obs.to_chrome_trace(build(obs, rng),
                                    slo_windows=obs.slo_windows_ms(
                                        _windows(rng)))
        PKG[checker].validate_trace(json.loads(json.dumps(trace)))


# the JAX package's own rejections (tests/test_obs.py), plus the
# container and type checks of validate_trace
MALFORMED = [
    ({"events": []}, "traceEvents"),
    ({"traceEvents": {}}, "must be a list"),
    ({"traceEvents": [3]}, "not an object"),
    ({"traceEvents": [{"name": "x", "ph": "B", "pid": 1, "tid": 0,
                       "ts": 0.0}]}, "unsupported ph"),
    ({"traceEvents": [{"name": "x", "ph": "X", "pid": 1, "tid": 0,
                       "ts": 0.0}]}, "missing 'dur'"),
    ({"traceEvents": [{"name": "x", "ph": "X", "pid": 1, "tid": 0,
                       "ts": 0.0, "dur": -1.0}]}, "negative dur"),
    ({"traceEvents": [{"name": "x", "ph": "X", "pid": 1, "tid": 0,
                       "ts": "0", "dur": 1.0}]}, "must be a number"),
    ({"traceEvents": [{"name": "x", "ph": "i", "pid": 1, "tid": 0,
                       "ts": 0.0, "s": "z"}]}, "bad instant scope"),
    ({"traceEvents": [{"name": "x", "ph": "s", "pid": 1, "tid": 0,
                       "ts": 0.0}]}, "missing 'cat'"),
]


@pytest.mark.parametrize("trace,match", MALFORMED)
def test_both_reject_the_same_malformed_traces(trace, match):
    msgs = []
    for obs in PKG.values():
        with pytest.raises(ValueError, match=match) as e:
            obs.validate_trace(trace)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_write_trace_round_trips(tmp_path):
    rng = np.random.default_rng(3)
    trace = TO.to_chrome_trace(_storm(TO, rng),
                               slo_windows=TO.slo_windows_ms(_windows(rng)),
                               meta={"run": "t"})
    path = TO.write_trace(str(tmp_path / "trace.json"), trace)
    with open(path) as f:
        back = json.load(f)
    assert back == json.loads(json.dumps(trace))
    RO.validate_trace(back)
    TO.validate_trace(back)
    with pytest.raises(ValueError):
        TO.write_trace(str(tmp_path / "bad.json"), {"events": []})
    assert not (tmp_path / "bad.json").exists()

"""The port's scenario engine against the JAX package's.

Every registered generator, the profile algebra, ``WorkloadDag`` and its
critical path, and ``run_scenario`` must give the same results in both
packages on the same seeds: samples ``to_dict()`` for ``to_dict()``,
totals and predictions bit for bit.  All of it is host arithmetic, so
the tolerance is exact equality.
"""
import pytest

import repro.scenarios as RS
import repro_torch.scenarios as TS
from repro.core import Emulator as REmulator
from repro.core import HostCalibration as RCal
from repro.fleet import critical_path as r_critical_path
from repro.fleet.executor import BundleTiming as RTiming
from repro.scenarios.dag import dag_diamond_workload as r_diamond
from repro.scenarios.dag import deep_chain_workload as r_chain
from repro_torch.core import Emulator as TEmulator
from repro_torch.core import HostCalibration as TCal
from repro_torch.core import ProfileStore as TProfileStore
from repro_torch.fleet import critical_path as t_critical_path
from repro_torch.fleet.executor import BundleTiming as TTiming
from repro_torch.scenarios.dag import dag_diamond_workload as t_diamond
from repro_torch.scenarios.dag import deep_chain_workload as t_chain

# the reference's registry (tests/test_scenarios.py, EXPECTED)
EXPECTED = {"training_scan", "serving_traffic", "fanout_straggler",
            "retry_storm", "mixed_fleet", "dag_diamond", "deep_chain"}

# every scenario at its defaults; the seeded ones at two more seeds; the
# unseeded ones at two other shapes
CASES = [(n, {}) for n in sorted(EXPECTED)] + [
    (n, {"seed": s}) for n in ("serving_traffic", "fanout_straggler",
                               "retry_storm", "mixed_fleet", "dag_diamond")
    for s in (1, 2)] + [
    ("training_scan", {"n_steps": 5, "ckpt_every": 2, "ici_per_step": 3e6}),
    ("training_scan", {"n_steps": 3, "ckpt_every": 0}),
    ("deep_chain", {"depth": 3, "decay": 0.5}),
    ("deep_chain", {"depth": 9, "samples_per": 3}),
]

TILE = 64
BLOCK = 1 << 18


def _dump(p):
    return {"command": p.command, "tags": dict(p.tags), "meta": p.meta,
            "samples": [s.to_dict() for s in p.samples],
            "totals": p.totals.to_dict()}


def test_registry_equals_reference():
    assert set(TS.list_scenarios()) == set(RS.list_scenarios()) == EXPECTED
    for name in EXPECTED:
        t, r = TS.get_scenario(name), RS.get_scenario(name)
        assert t.defaults == r.defaults
        assert t.description == r.description
    assert [s.__dict__ for s in TS.DEFAULT_SPECS] == \
        [s.__dict__ for s in RS.DEFAULT_SPECS]
    for export in ("DagNode", "WorkloadDag", "chain", "concat", "fork_join",
                   "overlay", "scale", "run_scenario", "run_fleet",
                   "ScenarioResult", "FleetResult"):
        assert hasattr(TS, export), export


@pytest.mark.parametrize("name,params", CASES,
                         ids=[f"{n}-{p}" for n, p in CASES])
def test_scenario_samples_equal_reference(name, params):
    t = TS.generate(name, **params)
    TS.validate(t)
    assert _dump(t) == _dump(RS.generate(name, **params))


def _pair(name, **kw):
    return TS.generate(name, **kw), RS.generate(name, **kw)


def test_concat_associative_bitwise_against_reference():
    (ta, ra), (tb, rb), (tc, rc) = (
        _pair("fanout_straggler", seed=3), _pair("retry_storm", seed=4),
        _pair("training_scan", n_steps=3, ckpt_every=2))
    left = TS.concat(TS.concat(ta, tb), tc, command="abc")
    right = TS.concat(ta, TS.concat(tb, tc), command="abc")
    assert _dump(left) == _dump(right)
    assert _dump(left) == _dump(RS.concat(RS.concat(ra, rb), rc,
                                          command="abc"))
    assert _dump(right) == _dump(RS.concat(ra, RS.concat(rb, rc),
                                           command="abc"))


def test_overlay_commutative_and_scale_bitwise_against_reference():
    (ta, ra), (tb, rb) = (_pair("mixed_fleet", seed=5),
                          _pair("fanout_straggler", n_workers=3))
    ab = TS.overlay(ta, tb, command="o")
    assert _dump(ab) == _dump(TS.overlay(tb, ta, command="o"))
    assert _dump(ab) == _dump(RS.overlay(ra, rb, command="o"))
    assert _dump(TS.scale(ab, 2.5)) == \
        _dump(RS.scale(RS.overlay(ra, rb, command="o"), 2.5))
    with pytest.raises(ValueError):
        TS.scale(ab, -1.0)
    with pytest.raises(ValueError):
        RS.scale(ra, -1.0)


def _dag_dump(d):
    return {"parents": d.parents_map, "n_edges": d.n_edges,
            "nodes": [_dump(p) for p in d.profiles()],
            "totals": d.totals.to_dict(),
            "linear": _dump(d.linearize(command="lin"))}


@pytest.mark.parametrize("build", ["diamond", "chain", "fork_join"])
def test_workload_dag_and_critical_path_equal_reference(build):
    if build == "diamond":
        t, r = (t_diamond(fanout=3, seed=2), r_diamond(fanout=3, seed=2))
    elif build == "chain":
        t, r = (t_chain(depth=4, decay=0.7), r_chain(depth=4, decay=0.7))
    else:
        (s, rs), (a, ra), (b, rb), (k, rk) = (
            _pair("training_scan", n_steps=2), _pair("retry_storm"),
            _pair("fanout_straggler"), _pair("mixed_fleet", seed=1))
        t = TS.fork_join(s, [a, b], k)
        r = RS.fork_join(rs, [ra, rb], rk)
    assert _dag_dump(t) == _dag_dump(r)
    # a timing for every node: start after the latest parent, uneven work
    start, tt, rt = {}, {}, {}
    for i, ps in sorted(t.parents_map.items()):
        disp = max((start[p] for p in ps), default=0.0) + 0.01 * i
        done = disp + 0.3 + 0.17 * ((i * 7) % 5)
        start[i] = done
        tt[i] = TTiming(enqueued=0.0, dispatched=disp, done=done,
                        queue_s=disp, replay_s=done - disp, attempts=1,
                        ok=True)
        rt[i] = RTiming(enqueued=0.0, dispatched=disp, done=done,
                        queue_s=disp, replay_s=done - disp, attempts=1,
                        ok=True)
    got = t_critical_path(t.parents_map, tt)
    assert got == r_critical_path(r.parents_map, rt)
    assert got["n_nodes"] == len(t)


def test_dag_rejects_forward_parents_like_reference():
    p, rp = _pair("retry_storm")
    for pkg, prof in ((TS, p), (RS, rp)):
        d = pkg.WorkloadDag()
        d.add(prof)
        with pytest.raises(ValueError):
            d.add(prof, parents=(1,))
        with pytest.raises(ValueError):
            d.add(prof, parents=(5,))


@pytest.mark.parametrize("name", ["training_scan", "serving_traffic",
                                  "dag_diamond"])
def test_run_scenario_equals_reference(name, tmp_path):
    t_store = TProfileStore(str(tmp_path / "t"))
    t_em = TEmulator(calib=TCal(1e9, 1e9, 1e8, 1e8), compute_tile=TILE,
                     mem_block=BLOCK, device="cpu")
    r_em = REmulator(calib=RCal(1e9, 1e9, 1e8, 1e8), compute_tile=TILE,
                     mem_block=BLOCK)
    t_em.storage.dir = r_em.storage.dir = str(tmp_path)
    kw = {"n_steps": 4, "ckpt_every": 2, "ckpt_bytes": 1 << 20} \
        if name == "training_scan" else {}
    try:
        t = TS.run_scenario(name, store=t_store, emulator=t_em, **kw)
        r = RS.run_scenario(name, emulator=r_em, **kw)
    finally:
        t_em.storage.cleanup()
        r_em.storage.cleanup()
    assert t.predictions == r.predictions
    assert set(t.predictions) == {s.name for s in TS.DEFAULT_SPECS}
    assert t.report.consumed.to_dict() == r.report.consumed.to_dict()
    assert (t.report.mode, t.report.n_samples) == \
        (r.report.mode, r.report.n_samples)
    # the stored profile carries the predictions and the emulated time
    back = t_store.latest(t.profile.command, t.profile.tags)
    assert back.meta["predictions"] == t.predictions
    assert back.meta["emulated_ttc_s"] == t.report.ttc_s
    summary = t.summary()
    assert summary["scenario"] == name and summary["run_id"] == t.run_id

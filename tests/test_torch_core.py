"""Host-side parity between the PyTorch port and the JAX package.

Everything that crosses between the two packages is data: profile JSON,
``CompiledSchedule.detach()`` payloads, reports, store directories.  Each
must load in both directions, and the accounting both packages derive from
it (tables, plan keys, predictions, scenario samples) must be
bit-identical.  A fixed ``HostCalibration`` keeps calibration timing out.
"""
import importlib
import json
import os
import pickle
from collections import namedtuple

import numpy as np
import pytest

import repro.core as R
import repro_torch.core as T
from repro.core.emulator import ReportFold as RReportFold
from repro.core.emulator import _collapse as r_collapse
from repro.scenarios import generate as r_generate
from repro_torch.core.emulator import _collapse as t_collapse
from repro_torch.scenarios import generate as t_generate

# the packages export a ``calibrate`` function over the module's name
r_calibrate_mod = importlib.import_module("repro.core.calibrate")
t_calibrate_mod = importlib.import_module("repro_torch.core.calibrate")

TILE = 64
BLOCK = 1 << 18
FPI = 2.0 * TILE ** 3
BPI = 2.0 * BLOCK
MeshSpec = namedtuple("MeshSpec", "shape axes")


def _ems(**kw):
    """The same emulator in both packages (the port's on the CPU)."""
    r = R.Emulator(calib=R.HostCalibration(1e9, 1e9, 1e8, 1e8),
                   compute_tile=TILE, mem_block=BLOCK, **kw)
    t = T.Emulator(calib=T.HostCalibration(1e9, 1e9, 1e8, 1e8),
                   compute_tile=TILE, mem_block=BLOCK, device="cpu", **kw)
    return r, t


def _profile(pkg, rvs, command="parity"):
    return pkg.SynapseProfile(
        command=command, tags={"k": "v"},
        samples=[pkg.Sample(index=i, resources=pkg.ResourceVector(**r),
                            duration_s=0.5 * i, label=f"s{i}")
                 for i, r in enumerate(rvs)])


def _rvs(n=12):
    out = []
    for i in range(n):
        rv = {"flops": (1 + i % 3) * FPI * 1.37,
              "hbm_bytes": (1 + i % 2) * BPI * 0.91}
        if i % 4 == 3:
            rv["ici_bytes"] = {"all-reduce": 3.0e5 * i}
        if i % 5 == 4:
            rv["storage_write_bytes"] = float(2 << 20)
        out.append(rv)
    return out


# ---------------------------------------------------------------------------
# datamodel and scenarios
# ---------------------------------------------------------------------------

def test_profile_json_both_directions():
    rp = r_generate("serving_traffic", n_requests=3, n_params=7.6e9,
                    kv_bytes_per_token=57344, seed=3)
    tp = T.SynapseProfile.from_json(rp.to_json())
    assert tp.to_json() == rp.to_json()
    assert tp.totals.to_dict() == rp.totals.to_dict()
    mine = _profile(T, _rvs())
    back = R.SynapseProfile.from_json(mine.to_json())
    assert back.to_json() == mine.to_json()
    assert back.key() == mine.key()


@pytest.mark.parametrize("params", [
    {},
    {"n_requests": 2, "prefill_tokens": 128, "decode_tokens": 16,
     "n_params": 7.6e9, "bytes_per_param": 2, "kv_bytes_per_token": 57344,
     "seed": 0},
    {"n_requests": 5, "rate_hz": 3.0, "hw": "i7_m620", "seed": 11},
])
def test_serving_traffic_generates_identical_samples(params):
    rp = r_generate("serving_traffic", **params)
    tp = t_generate("serving_traffic", **params)
    assert [s.to_dict() for s in tp.samples] == \
        [s.to_dict() for s in rp.samples]
    assert tp.tags == rp.tags and tp.meta == rp.meta
    assert tp.command == rp.command


def test_scenario_registry_validates_like_reference():
    from repro.scenarios import list_scenarios as r_list_scenarios
    from repro_torch.scenarios import list_scenarios, validate
    # every scenario family is ported (the registry grew from
    # serving_traffic alone to the reference's set)
    assert list_scenarios() == r_list_scenarios()
    with pytest.raises(TypeError):
        t_generate("serving_traffic", bogus=1)
    bad = _profile(T, [{"flops": -1.0}])
    with pytest.raises(ValueError):
        validate(bad)


def test_hardware_specs_match_reference():
    from repro.core import hardware as rh
    from repro_torch.core import hardware as th
    assert {k: v.__dict__ for k, v in th.REGISTRY.items()} == \
        {k: v.__dict__ for k, v in rh.REGISTRY.items()}
    assert th.TPU_V5E_POD.__dict__ == rh.TPU_V5E_POD.__dict__


# ---------------------------------------------------------------------------
# predictor
# ---------------------------------------------------------------------------

def test_predict_and_compare_match():
    rp = r_generate("serving_traffic", n_requests=4, n_params=7.6e9,
                    kv_bytes_per_token=57344)
    tp = T.SynapseProfile.from_json(rp.to_json())
    for name in R.hardware.REGISTRY:
        a = R.predict(rp, R.get_spec(name, chips=4), storage_bps=1e8)
        b = T.predict(tp, T.get_spec(name, chips=4), storage_bps=1e8)
        assert (b.ttc_max, b.ttc_sum, b.roofline_fraction()) == \
            (a.ttc_max, a.ttc_sum, a.roofline_fraction())
        assert b.terms.to_dict() == a.terms.to_dict()
        assert [t.to_dict() for t in b.per_sample] == \
            [t.to_dict() for t in a.per_sample]
    specs = [R.TPU_V5E, R.get_spec("i7_m620")]
    tspecs = [T.TPU_V5E, T.get_spec("i7_m620")]
    assert T.compare(tp, tspecs) == R.compare(rp, specs)
    assert T.predict_fleet([tp, tp], T.TPU_V5E) == \
        R.predict_fleet([rp, rp], R.TPU_V5E)
    args = (96, 24, 1.5e9, 2.0, 4096.0)
    assert [v.to_dict() for v in T.llm_request_resources(*args)] == \
        [v.to_dict() for v in R.llm_request_resources(*args)]


# ---------------------------------------------------------------------------
# store
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["reference", "port"])
def test_store_directory_reads_in_other_package(tmp_path, writer):
    pkgs = {"reference": R, "port": T}
    w = pkgs[writer]
    r = pkgs["port" if writer == "reference" else "reference"]
    ws = w.ProfileStore(str(tmp_path))
    profs = [_profile(w, _rvs(5), command="store"),
             _profile(w, _rvs(7), command="store")]
    for p in profs:
        ws.add(p)
    rs = r.ProfileStore(str(tmp_path))
    got = rs.query("store", {"k": "v"})
    assert [p.to_json() for p in got] == [p.to_json() for p in profs]
    assert rs.latest("store", {"k": "v"}).to_json() == profs[-1].to_json()
    assert rs.keys() == ws.keys()
    assert rs.stats("store", {"k": "v"}).__dict__ == \
        ws.stats("store", {"k": "v"}).__dict__
    assert [p.to_json() for p in rs.find({"k": "v"})] == \
        [p.to_json() for p in profs]


# ---------------------------------------------------------------------------
# atoms: quantization, plan keys, amounts
# ---------------------------------------------------------------------------

_BACKEND = {"jnp": "torch", "pallas": "cuda"}


@pytest.mark.parametrize("efficiency", [1.0, 0.37])
def test_iters_plan_keys_and_amounts_match(efficiency):
    ra = R.ComputeAtom(tile=TILE, efficiency=efficiency)
    ta = T.ComputeAtom(tile=TILE, efficiency=efficiency, device="cpu")
    rm = R.MemoryAtom(block_bytes=BLOCK)
    tm = T.MemoryAtom(block_bytes=BLOCK, device="cpu")
    rc, tc = R.PlanCache(), T.PlanCache()
    for a in (ra, rm):
        a.cache = rc
    for a in (ta, tm):
        a.cache = tc
    amounts = [0.0, 0.2 * FPI, 0.5 * FPI, 0.51 * FPI, FPI, 2.5 * FPI,
               3.5 * FPI, 1e3 * FPI, 7.77e6 * FPI]
    for x in amounts:
        assert ta.iters_for(x) == ra.iters_for(x)
        assert tm.iters_for(x / FPI * BPI) == rm.iters_for(x / FPI * BPI)
        assert ta.plan(x).amount == ra.plan(x).amount
        assert tm.plan(x / FPI * BPI).amount == rm.plan(x / FPI * BPI).amount
    rkeys = {(k[0], _BACKEND[k[1]], *k[2:]) for k in rc._plans}
    assert set(tc._plans) == rkeys
    assert tc.stats() == rc.stats()
    assert ta.spec().__dict__ == {**ra.spec().__dict__, "backend": "torch"}
    hw = R.TPU_V5E
    assert ta.seconds(1e12, hw) == ra.seconds(1e12, hw)
    assert tm.seconds(1e12, hw) == rm.seconds(1e12, hw)


def test_collective_quant_matches():
    for n in (1, 2, 4, 8):
        for kind in ("all-reduce", "all-gather", "collective-permute",
                     "all-to-all"):
            rq, tq = R.CollectiveQuant(n=n, kind=kind), \
                T.CollectiveQuant(n=n, kind=kind)
            assert tq.to_dict() == rq.to_dict()
            assert tq.wire_bytes_per_iter == rq.wire_bytes_per_iter
            for w in (0.0, 1e3, 2.6e5, 1e9):
                assert tq.iters_for(w) == rq.iters_for(w)
            assert T.collective_factor(kind, n) == R.collective_factor(kind, n)
    ms = MeshSpec(shape=(2, 4), axes=("data", "model"))
    assert T.CollectiveSpec().quant_for(ms).to_dict() == \
        R.CollectiveSpec().quant_for(ms).to_dict()


def test_unknown_backend_rejected():
    with pytest.raises(ValueError, match="backend"):
        T.ComputeAtom(backend="jnp", device="cpu")
    with pytest.raises(ValueError, match="backend"):
        T.Emulator(calib=T.HostCalibration(1, 1, 1, 1), backend="pallas",
                   device="cpu")


# ---------------------------------------------------------------------------
# schedules: tables and payloads
# ---------------------------------------------------------------------------

def _tables(sched):
    return [(type(s).__name__,
             s.table.tolist() if hasattr(s, "table") else
             (s.resources.to_dict(), s.count),
             [r.to_dict() for r in getattr(s, "rows", [])])
            for s in sched.steps]


@pytest.mark.parametrize("kw", [
    {}, {"flops_scale": 3.0, "mem_scale": 0.5}, {"keep_collectives": True},
    {"keep_collectives": False},
    {"mesh_spec": MeshSpec(shape=(4,), axes=("x",))},
])
@pytest.mark.parametrize("speed", [1.0, 2.0])
def test_compile_tables_match(kw, speed):
    r, t = _ems(speed=speed)
    rp, tp = _profile(R, _rvs(16)), _profile(T, _rvs(16))
    rs, ts = r.compile(rp, **kw), t.compile(tp, **kw)
    assert _tables(ts) == _tables(rs)
    assert ts.describe() == rs.describe()
    assert ts.mesh_bound == rs.mesh_bound
    assert (ts.collective_quant is None) == (rs.collective_quant is None)
    # the quantization is the atoms' own (mirrors tests/test_schedule.py)
    if not kw:
        runs = t_collapse(tp.samples)
        want = [(t.compute.iters_for(x.flops / speed),
                 t.memory.iters_for(x.hbm_bytes / speed), 0)
                for x, c in runs if not x.storage_write_bytes]
        got = [tuple(row) for s in ts.segments for row in s.table]
        assert got == want


def test_identical_samples_collapse_like_reference():
    r, t = _ems()
    rvs = [{"flops": FPI, "hbm_bytes": BPI}] * 16
    rs, ts = r.compile(_profile(R, rvs)), t.compile(_profile(T, rvs))
    assert _tables(ts) == _tables(rs)
    assert ts.segments[0].n_rows == 1
    assert ts.segments[0].compute_iters == t.compute.iters_for(16 * FPI)
    assert [(x.to_dict(), c) for x, c in t_collapse(_profile(T, rvs).samples)] \
        == [(x.to_dict(), c) for x, c in r_collapse(_profile(R, rvs).samples)]


@pytest.mark.parametrize("kw", [{}, {"mesh_spec": MeshSpec((2,), ("x",))},
                                {"keep_collectives": True}])
def test_payloads_cross_both_ways(kw):
    r, t = _ems()
    rs = r.compile(_profile(R, _rvs(16)), **kw)
    ts = t.compile(_profile(T, _rvs(16)), **kw)

    def norm(p):
        return pickle.dumps({**p, "steps": [
            {**s, "table": s["table"].tolist()} if "table" in s else s
            for s in p["steps"]]})

    # reference -> port -> reference, and port -> reference -> port
    via_port = R.rehydrate_schedule(
        T.rehydrate_schedule(rs.detach()).detach())
    via_ref = T.rehydrate_schedule(
        R.rehydrate_schedule(ts.detach()).detach())
    assert norm(via_port.detach()) == norm(rs.detach()) == norm(ts.detach())
    assert norm(via_ref.detach()) == norm(ts.detach())
    # and through pickle, as a fleet ships them
    assert norm(T.rehydrate_schedule(
        pickle.loads(pickle.dumps(rs.detach()))).detach()) == norm(rs.detach())


def test_v1_payload_loads_in_both():
    payload = {"version": 1, "steps": [
        {"kind": "segment", "table": np.array([[1, 2], [0, 3]], np.int32),
         "rows": [{"flops": FPI, "hbm_bytes": 2 * BPI},
                  {"flops": 0.0, "hbm_bytes": 3 * BPI}]},
        {"kind": "barrier", "resources": {"storage_write_bytes": 1e6},
         "count": 2}]}
    rs, ts = R.rehydrate_schedule(payload), T.rehydrate_schedule(payload)
    assert _tables(ts) == _tables(rs)
    assert ts.segments[0].table.tolist() == [[1, 2, 0], [0, 3, 0]]
    for bad in ({"version": 9, "steps": []},
                {"version": 2, "steps": [{"kind": "nope"}]}):
        with pytest.raises(ValueError):
            T.rehydrate_schedule(bad)


# ---------------------------------------------------------------------------
# reports
# ---------------------------------------------------------------------------

def test_reports_load_in_other_package():
    r, t = _ems()
    rp, tp = _profile(R, _rvs(6)), _profile(T, _rvs(6))
    for rep, other in ((r.emulate(rp), T), (t.emulate(tp), R)):
        d = json.loads(json.dumps(rep.to_dict()))
        back = other.EmulationReport.from_dict(d)
        assert back.to_dict() == rep.to_dict()
        assert back.summary() == rep.summary()
    tr = t.emulate(tp)
    fleet = T.FleetReport(
        reports=[tr], wall_s=1.5, serial_s=2.5, max_workers=2,
        cache_stats={"plans_built": 3}, totals=tr.consumed, n_samples=6,
        n_replayed=1, scaling={"scale_ups": 1},
        recovery={"fault_events": [(1.0, 2.0)], "requeued": 1},
        obs={"n_events": 0}, dag={"slack_s": {0: 0.0, 3: 1.5},
                                  "critical_path_s": 2.0})
    wire = json.loads(json.dumps(fleet.to_json()))
    rf = R.FleetReport.from_json(wire)
    assert rf.to_json() == fleet.to_json()
    assert T.FleetReport.from_json(json.loads(json.dumps(rf.to_json()))
                                   ).summary() == fleet.summary()
    with pytest.raises(ValueError, match="schema"):
        T.FleetReport.from_json({**wire, "schema": 2})


def test_report_fold_orders_like_reference():
    r, t = _ems()
    reps = [T.EmulationReport.from_dict(
        r.emulate(_profile(R, _rvs(3 + i))).to_dict()) for i in range(4)]
    rf, tf = RReportFold(), T.ReportFold()
    for idx in (2, 0, 3):
        rf.add(idx, R.EmulationReport.from_dict(reps[idx].to_dict()))
        tf.add(idx, reps[idx])
    rf.skip(1)
    tf.skip(1)
    assert tf.totals.to_dict() == rf.totals.to_dict()
    assert (tf.n_done, tf.n_skipped, tf.serial_s) == \
        (rf.n_done, rf.n_skipped, rf.serial_s)


# ---------------------------------------------------------------------------
# calibration and watchers
# ---------------------------------------------------------------------------

def test_calibration_cache_is_the_ports_own(tmp_path, monkeypatch):
    assert t_calibrate_mod.cache_path("cuda") != r_calibrate_mod.CACHE_PATH
    assert t_calibrate_mod.cache_path("cpu") != \
        t_calibrate_mod.cache_path("cuda")
    monkeypatch.setattr(t_calibrate_mod, "CACHE_DIR", str(tmp_path))
    cal = T.calibrate(force=True, device="cpu")
    assert cal.flops_per_s > 0 and cal.stream_bytes_per_s > 0
    assert cal.storage_write_bps > 0 and cal.storage_read_bps > 0
    assert os.listdir(tmp_path) == ["synapse_torch_calib_cpu.json"]
    assert T.calibrate(device="cpu") == cal          # read back from cache
    # the reference's HostCalibration reads the port's cache file as is
    with open(tmp_path / "synapse_torch_calib_cpu.json") as f:
        assert R.HostCalibration(**json.load(f)).__dict__ == cal.__dict__


def test_runtime_profile_loads_in_reference():
    prof = T.RuntimeProfiler(sample_rate=50).profile_callable(
        lambda: sum(range(200000)), command="watch", tags={"w": "1"})
    assert prof.samples and prof.meta["wall_s"] > 0
    back = R.SynapseProfile.from_json(prof.to_json())
    assert back.to_json() == prof.to_json()
    assert set(T.host_sysinfo()) == set(R.host_sysinfo())

"""The port's live traffic service against the JAX package's.

Host-side pieces must equal the reference exactly: seeded arrival
timelines of every kind, recorded trace logs crossing both ways,
``LoadService._parse`` over the reference's query table, the socketless
routes, and ``StandingFleet`` sessions on injected loopback pools (the
reference's ``_EchoFleet`` pattern, ``tests/test_service.py``).  One HTTP
server runs on port 0.  Two tests spawn CPU workers (each pinned to one
OMP thread): ``StandingFleet`` sessions on a warm process pool, with
totals equal to the JAX package's in-process replay, and the reference's
seeded chaos storm contract (``tests/test_service.py``) on the port.
"""
import json
import multiprocessing as mp
import threading
import urllib.request

import numpy as np
import pytest

import repro.core as R
import repro.core.emulator as r_emulator
import repro.fleet as RF
import repro.scenarios as RS
import repro.service as RSV
import repro_torch.core as T
import repro_torch.core.emulator as t_emulator
import repro_torch.fleet as TF
import repro_torch.scenarios as TS
import repro_torch.service as TSV
from repro.service.http import LoadService as RLoadService
from repro_torch.obs import parse_promtext
from repro_torch.service.http import LoadService as TLoadService
from repro_torch.service.http import make_server

TILE = 64                  # 1 compute iter = 2*64^3  = 524288 flops
BLOCK = 1 << 18            # 1 memory  iter = 2*2^18  = 524288 bytes
FPI = 2.0 * TILE ** 3
BPI = 2.0 * BLOCK

PKG = {"torch": (T, TF, TSV, t_emulator, TS),
       "jax": (R, RF, RSV, r_emulator, RS)}


def _em(pkg):
    core = PKG[pkg][0]
    extra = {"device": "cpu"} if pkg == "torch" else {}
    return core.Emulator(calib=core.HostCalibration(1e9, 1e9, 1e8, 1e8),
                         compute_tile=TILE, mem_block=BLOCK, **extra)


# ---------------------------------------------------------------------------
# arrival processes
# ---------------------------------------------------------------------------

def _process(svc, kind, seed):
    params = {"fanout": 3, "prefill_tokens": 32}
    if kind == "constant":
        return svc.ConstantArrivals(rate_hz=7.0, n_requests=40,
                                    scenario="svc", params=params,
                                    seed=seed)
    if kind == "poisson":
        return svc.PoissonArrivals(rate_hz=50.0, n_requests=200,
                                   scenario="svc", params=params, seed=seed)
    if kind == "diurnal":
        return svc.DiurnalArrivals(base_hz=2.0, peak_hz=40.0, period_s=10.0,
                                   duration_s=10.0, scenario="svc",
                                   params=params, seed=seed)
    # a recorded trace of a Poisson run, truncated by a duration bound
    rec = svc.PoissonArrivals(rate_hz=30.0, n_requests=60, scenario="svc",
                              params=params, seed=seed).trace()
    return svc.TraceArrivals(log=rec.log, duration_s=1.0)


def _timeline(p):
    return [(a.t, a.scenario, a.params) for a in p]


@pytest.mark.parametrize("seed", [0, 7, 11])
@pytest.mark.parametrize("kind", ["constant", "poisson", "diurnal",
                                  "trace"])
def test_arrival_timelines_equal_reference(kind, seed):
    t, r = _process(TSV, kind, seed), _process(RSV, kind, seed)
    assert _timeline(t) == _timeline(r)
    assert len(_timeline(t)) > 0
    assert _timeline(t) == _timeline(t)      # iterating never mutates
    if kind in TSV.ARRIVAL_KINDS:
        f = TSV.arrival_process(kind, "svc", seed=seed, n_requests=25,
                                params={"b": 2, "a": 1})
        g = RSV.arrival_process(kind, "svc", seed=seed, n_requests=25,
                                params={"b": 2, "a": 1})
        assert _timeline(f) == _timeline(g)


def test_arrival_validation_equals_reference():
    assert set(TSV.ARRIVAL_KINDS) == set(RSV.ARRIVAL_KINDS)
    for make in (lambda s: s.ConstantArrivals(rate_hz=0.0, n_requests=1),
                 lambda s: s.ConstantArrivals(rate_hz=1.0),
                 lambda s: s.PoissonArrivals(rate_hz=1.0, n_requests=-1),
                 lambda s: s.DiurnalArrivals(base_hz=5.0, peak_hz=1.0,
                                             n_requests=3),
                 lambda s: s.Arrival(t=-0.1, scenario="svc"),
                 lambda s: s.TraceArrivals(log=(
                     s.Arrival(t=1.0, scenario="svc"),
                     s.Arrival(t=0.5, scenario="svc"))),
                 lambda s: s.arrival_process("wat", "svc", n_requests=5)):
        msgs = []
        for svc in (TSV, RSV):
            with pytest.raises(ValueError) as e:
                make(svc)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


@pytest.mark.parametrize("src,dst", [("torch", "jax"), ("jax", "torch")])
def test_trace_logs_load_in_both_packages(src, dst):
    p = _process(PKG[src][2], "poisson", 5)
    log = json.loads(json.dumps(p.trace().to_log()))   # the JSON form
    back = PKG[dst][2].TraceArrivals.from_log(log)
    assert _timeline(back) == _timeline(p)
    assert back.to_log() == p.trace().to_log()


# ---------------------------------------------------------------------------
# HTTP layer: parsing and routes without sockets, one server on port 0
# ---------------------------------------------------------------------------

def _service(pkg):
    return {"torch": TLoadService, "jax": RLoadService}[pkg](_em(pkg))


# the reference's query table (tests/test_service.py) and its edges
QUERIES = [
    {"scenario": "serving_traffic", "process": "poisson", "rate_hz": 20.0,
     "n": 10, "seed": 11, "kill_every": 5, "chaos_seed": 3, "p_fanout": 4,
     "workers": 1, "slo_ms": 100.0, "slo_pct": 0.999},
    {"n": 5},
    {},
    {"process": "constant", "rate": 3.0, "base_hz": 1.0, "duration": 2.0},
    {"process": "diurnal", "base_hz": 1.0, "peak_hz": 9.0, "period_s": 4.0,
     "n_requests": 7, "time_scale": 10.0, "window_s": 0.5},
    {"workers": 3, "autoscale": True, "min_workers": 2, "liveness": 2.0,
     "hang_nth": 2, "fail_nth": 3, "delay_every": 4, "max_faults": 1,
     "max_respawns": 5, "timeout": 60.0},
]


def _public(spec):
    return {k: (repr(v) if k in ("config", "slo") else v)
            for k, v in spec.items()}


@pytest.mark.parametrize("q", QUERIES, ids=range(len(QUERIES)))
def test_load_service_parse_equals_reference(q):
    t, r = _service("torch")._parse(dict(q)), _service("jax")._parse(dict(q))
    assert _public(t) == _public(r)
    assert isinstance(t["config"], TF.FleetConfig)
    assert t["config"].on_failure == "skip"


def test_load_service_parse_rejects_like_reference():
    for q in ({"process": "wat"}, {"rate_hz": "fast"}):
        msgs = []
        for pkg in PKG:
            with pytest.raises(ValueError) as e:
                _service(pkg)._parse(q)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


def test_load_service_routes_without_sockets():
    svc, ref = _service("torch"), _service("jax")
    for path in ("/healthz", "/scenarios", "/runs", "/healthz/"):
        assert svc.route(path) == ref.route(path)
    assert svc.route("/healthz") == {"ok": True}
    assert svc.route("/scenarios")["processes"] == \
        sorted(TSV.ARRIVAL_KINDS)
    for path, err in (("/nope", KeyError), ("/status?id=99", KeyError),
                      ("/trace?id=1", KeyError), ("/stop?id=x", KeyError),
                      ("/run?process=wat", ValueError)):
        with pytest.raises(err):
            svc.route(path)
        with pytest.raises(err):
            ref.route(path)
    # a bad spec fails in parsing, before any pool is spawned
    assert svc.runs() == {"runs": []}


def test_load_service_defaults_to_the_card():
    if __import__("torch").cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        TLoadService()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_server(port=0)


def test_http_server_smoke_port_zero():
    server = make_server(port=0, emulator=_em("torch"))
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        host, port = server.server_address[:2]
        assert port > 0
        base = f"http://{host}:{port}"
        with urllib.request.urlopen(f"{base}/healthz", timeout=10) as r:
            assert json.loads(r.read()) == {"ok": True}
        with urllib.request.urlopen(f"{base}/scenarios", timeout=10) as r:
            assert "poisson" in json.loads(r.read())["processes"]
        with urllib.request.urlopen(f"{base}/metrics", timeout=10) as r:
            assert r.headers["Content-Type"].startswith("text/plain")
            fams = parse_promtext(r.read().decode())
        assert "repro_service_runs_total" in fams
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"{base}/nope", timeout=10)
        assert e.value.code == 404
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"{base}/run?process=wat", timeout=10)
        assert e.value.code == 400
    finally:
        server.shutdown()
        t.join(10)
        server.service.shutdown()
        server.server_close()
    assert not t.is_alive()                  # clean shutdown


# ---------------------------------------------------------------------------
# StandingFleet over injected loopback pools (no subprocesses)
# ---------------------------------------------------------------------------

def _echo_fleet(pkg, n=1):
    F, emu = PKG[pkg][1], PKG[pkg][3]

    class EchoPeer(F.Peer):
        def __init__(self):
            super().__init__()
            self._r, self._w = mp.Pipe(duplex=False)
            self.ready = True

        @property
        def waitable(self):
            return self._r

        def dispatch(self, epoch, idx, bundle):
            self.tasks.add((epoch, idx))
            if bundle.command.startswith("poison"):
                self._w.send(("err", epoch, idx, "synthetic poison"))
                return
            self._w.send(("ok", epoch, idx, emu.EmulationReport(
                command=bundle.command, ttc_s=1e-3,
                n_samples=bundle.n_profile_samples,
                consumed=bundle.planned, mode="fused")))

        def recv(self):
            return self._r.recv()

        def close(self):
            self._r.close()
            self._w.close()

    class EchoFleet(F.FleetBase):
        def __init__(self):
            super().__init__()
            for _ in range(n):
                self._peers.append(EchoPeer())

    return EchoFleet()


def _echo_bundle(pkg, i, command=None):
    core, F = PKG[pkg][0], PKG[pkg][1]
    # awkward float amounts: identical totals mean an identical fold order
    return F.ScheduleBundle(command=command or f"echo{i}", payload={},
                            n_profile_samples=1,
                            planned=core.ResourceVector(
                                flops=0.1 * i + 0.3, hbm_bytes=0.7 * i))


def _echo_sessions(pkg):
    F, svc = PKG[pkg][1], PKG[pkg][2]
    cfg = F.FleetConfig.process(max_workers=1, on_failure="skip",
                                timeout=30.0)
    out = []
    with _echo_fleet(pkg) as pool:
        sf = svc.StandingFleet(None, cfg, fleet=pool)
        seen = []
        unsub = sf.on_complete(
            lambda rec, rep: seen.append((rec.idx, rep is not None)))
        with pytest.raises(RuntimeError):
            sf.drain()                       # no session yet
        with pytest.raises(ValueError):
            sf.submit()                      # exactly one of profile/bundle
        for i in range(5):
            cmd = "poison" if i == 3 else None
            assert sf.submit(bundle=_echo_bundle(pkg, i, cmd)) == i
        res = sf.drain(timeout=10.0)
        out.append((res.totals.to_dict(), res.n_ok, res.n_skipped,
                    [(r.idx, r.command, r.ok) for r in res.records]))
        assert all(r.done >= r.submitted for r in res.records)
        assert all(isinstance(r.timing, F.BundleTiming)
                   for r in res.records)
        unsub()
        assert sf.submit(bundle=_echo_bundle(pkg, 9)) == 0
        res2 = sf.drain(timeout=10.0)
        out.append((res2.totals.to_dict(), res2.n_ok,
                    [r.idx for r in res2.records], sorted(seen)))
        fr = res2.fleet_report().to_json(reports=False)
        out.append((fr["totals"], fr["n_replayed"]))
        sf.close()
        with pytest.raises(RuntimeError):
            sf.submit(bundle=_echo_bundle(pkg, 9))
    return out


def test_standing_fleet_sessions_on_loopback_equal_reference():
    t, r = _echo_sessions("torch"), _echo_sessions("jax")
    assert t == r
    assert t[0][1:3] == (4, 1)               # one poison request skipped
    assert t[1][3] == [(0, True), (1, True), (2, True), (3, False),
                       (4, True)]            # the hook stayed unsubscribed


# ---------------------------------------------------------------------------
# real worker processes on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture
def one_thread(monkeypatch):
    """Spawned CPU workers run torch on one intra-op thread each."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _jobs(S):
    return [S.generate("fanout_straggler", n_workers=4, work_flops=2e7,
                       work_hbm=4e6, seed=1),
            S.generate("retry_storm", n_tasks=4, work_flops=2e7,
                       work_hbm=2e6, seed=2),
            S.generate("serving_traffic", n_requests=2, n_params=1e6,
                       prefill_tokens=32, decode_tokens=4, seed=3)]


def test_standing_fleet_on_a_warm_process_pool(tmp_path, one_thread):
    """Two serve sessions on one warm 1-worker pool: every request done,
    each report's consumed equal to the JAX package's in-process replay,
    totals folded bit-identical to the reference's fold, and the second
    session pays no spawn."""
    r_em, t_em = _em("jax"), _em("torch")
    r_em.storage.dir = t_em.storage.dir = str(tmp_path)
    refs = [r_em.emulate(p, fused=True) for p in _jobs(RS)]
    r_em.storage.cleanup()
    fold = r_emulator.ReportFold(keep_reports=False)
    for i, ref in enumerate(refs):
        fold.add(i, ref)
    reports = []
    cfg = TF.FleetConfig.process(max_workers=1, timeout=120.0)
    with TSV.StandingFleet(t_em, cfg) as sf:
        info, = sf.warmup(timeout=120.0)
        assert info["device"] == "cpu"
        sf.on_complete(lambda rec, rep: reports.append((rec.idx, rep)))
        pids = list(sf.fleet.pids)
        for session in range(2):
            for p in _jobs(TS):
                sf.submit(p, meta={"session": session})
            res = sf.drain(timeout=120.0)
            assert res.n_ok == 3 and res.n_skipped == 0
            assert [r.ok for r in res.records] == [True] * 3
            assert res.totals.to_dict() == fold.totals.to_dict()
            assert res.recovery["worker_deaths"] == 0
            assert res.obs["events"]
        assert sf.fleet.pids == pids         # the same warm worker
    assert len(reports) == 6
    for idx, rep in reports:
        assert rep.mode == "fused"
        assert rep.consumed.to_dict() == refs[idx].consumed.to_dict()


def _probe_profile(core, units=4):
    return core.SynapseProfile(
        command="svc-probe",
        samples=[core.Sample(index=i, resources=core.ResourceVector(
            flops=FPI, hbm_bytes=BPI)) for i in range(units)])


def _chaos_load_run():
    arrivals = TSV.PoissonArrivals(rate_hz=20.0, n_requests=12,
                                   scenario="svc_probe", seed=11)
    config = TF.FleetConfig.process(
        max_workers=1,
        chaos=TF.ChaosPolicy(seed=3, kill_every=5, max_faults=1),
        liveness_timeout=5.0, max_respawns=6, timeout=300.0)
    return TSV.run_load(_em("torch"), arrivals, config=config,
                        slo=TSV.SLO(target_ms=100.0, percentile=0.999),
                        window_s=0.5)


def test_seeded_chaos_storm_reproducible_and_mttr_lands_in_p999(one_thread):
    """The reference's acceptance contract on the port: the same (arrival
    seed, chaos seed) gives the same arrival timeline (the reference's
    too) and fault schedule run to run, exact request totals, and the
    kill's MTTR visible in the faulted windows' p999."""
    from repro_torch.scenarios.base import _REGISTRY
    TS.register("svc_probe", "exact-amount service probe", units=4)(
        lambda units=4: _probe_profile(T, units))
    try:
        mk = {pkg: (lambda svc=PKG[pkg][2]: svc.PoissonArrivals(
            rate_hz=20.0, n_requests=12, scenario="svc_probe", seed=11))
            for pkg in PKG}
        assert _timeline(mk["torch"]()) == _timeline(mk["jax"]())
        r1 = _chaos_load_run()
        r2 = _chaos_load_run()
        for rep in (r1, r2):
            assert rep.n_arrivals == 12
            assert rep.serve.n_ok == 12 and rep.serve.n_skipped == 0
            # exact totals: 12 requests x 4 samples, nothing lost to chaos
            assert rep.serve.totals.flops == 12 * 4 * FPI
            assert rep.serve.totals.hbm_bytes == 12 * 4 * BPI
            rec = rep.serve.recovery
            assert rec["worker_deaths"] >= 1      # the kill fired
            assert rec["mttr_s"] and rec["mttr_s"] > 0
            assert rep.slo["n_completed"] == 12
            faulted = [w for w in rep.slo["windows"] if w["faults"]]
            assert faulted, "the kill must mark SLO windows"
            assert max(w["p999"] for w in faulted) >= 0.5 * rec["mttr_s"]
            assert len(rep.slo["faults"]) == rec["worker_deaths"]
            # the report serializes through the one versioned schema
            d = json.loads(json.dumps(rep.to_dict()))
            assert d["n_ok"] == 12 and d["fleet"]["obs"]["n_events"] > 0
        assert (r1.serve.recovery["worker_deaths"]
                == r2.serve.recovery["worker_deaths"])
        assert len(r1.slo["faults"]) == len(r2.slo["faults"])
        assert [r.meta["t"] for r in r1.serve.records] == \
            [r.meta["t"] for r in r2.serve.records]
    finally:
        _REGISTRY.pop("svc_probe", None)

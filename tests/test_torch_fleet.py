"""The port's fleet against the JAX package's.

Host-side accounting must be bit-identical: ``FleetConfig`` validation and
legacy folding, chaos decision streams, the scheduler's event sequence
and folded totals on in-process fake peers (the reference's
``_EchoPeer`` pattern, ``tests/test_fleet.py``), thread-fleet totals and
plan-cache counts, and process-fleet reports against the reference's
in-process fused replay.  Process tests spawn at most 2 CPU workers each;
the port's workers run on the device the parent names, here ``"cpu"``.
"""
import dataclasses
import json
import multiprocessing as mp
import os
import pickle
import signal

import pytest
import torch

import repro.core as R
import repro.fleet as RF
import repro.scenarios as RS
import repro_torch.core as T
import repro_torch.fleet as TF
import repro_torch.scenarios as TS
from repro.core import emulator as r_emulator
from repro.obs.recorder import event_sequence as r_sequence
from repro_torch.core import emulator as t_emulator
from repro_torch.kernels.compute_atom import kernel as tck
from repro_torch.kernels.memory_atom import kernel as tmk
from repro_torch.obs.recorder import event_sequence as t_sequence

TILE = 64                  # 1 compute iter = 2*64^3  = 524288 flops
BLOCK = 1 << 18            # 1 memory  iter = 2*2^18  = 524288 bytes
FPI = 2.0 * TILE ** 3
BPI = 2.0 * BLOCK

PKG = {"torch": (T, TF, TS, t_emulator), "jax": (R, RF, RS, r_emulator)}


def _em(pkg, tmp_path=None, **kw):
    core = PKG[pkg][0]
    extra = {"device": "cpu"} if pkg == "torch" else {}
    em = core.Emulator(calib=core.HostCalibration(1e9, 1e9, 1e8, 1e8),
                       compute_tile=TILE, mem_block=BLOCK, **extra, **kw)
    if tmp_path is not None:
        em.storage.dir = str(tmp_path)
    return em


def _jobs(pkg, compute_only=False):
    """A small job set of every family: storage legs (checkpoints), memory
    legs unless ``compute_only`` (the reference's pallas memory leg cannot
    run, ROADMAP.md queue 3)."""
    S = PKG[pkg][2]
    hbm = 0.0 if compute_only else 1.0
    jobs = [S.generate("training_scan", n_steps=4, ckpt_every=2,
                       flops_per_step=4e7, hbm_per_step=2e6 * hbm,
                       ckpt_bytes=2 << 20),
            S.generate("fanout_straggler", n_workers=4, work_flops=2e7,
                       work_hbm=4e6 * hbm, seed=1),
            S.generate("retry_storm", n_tasks=4, work_flops=2e7,
                       work_hbm=2e6 * hbm, seed=2)]
    if not compute_only:
        jobs += [S.generate("mixed_fleet", total_samples=8, seed=1),
                 S.generate("serving_traffic", n_requests=2, n_params=1e6,
                            prefill_tokens=32, decode_tokens=4, seed=3)]
    return jobs


def _report_dump(rep):
    return {"command": rep.command, "consumed": rep.consumed.to_dict(),
            "n_samples": rep.n_samples, "mode": rep.mode,
            "planned": (None if rep.planned is None
                        else rep.planned.to_dict()),
            "n_collective_dispatches": rep.n_collective_dispatches}


# ---------------------------------------------------------------------------
# FleetConfig
# ---------------------------------------------------------------------------

def _configs(pkg):
    F = PKG[pkg][1]
    mesh = F.MeshSpec(shape=(2,), axes=("model",))
    chaos = F.ChaosPolicy(seed=1, kill_every=2, max_faults=1)
    return [
        dict(), dict(executor="process", max_workers=3, window=5),
        dict(executor="process", autoscale=True, min_workers=2),
        dict(executor="remote", hosts=["a:1", "b:2"]),
        dict(executor="remote", listen="127.0.0.1:0", agents=2),
        dict(executor="process", mesh_spec=mesh, chaos=chaos,
             liveness_timeout=2.0, speculate=1.5, on_failure="skip",
             max_respawns=3, dag=True),
        # every one of these raises in both packages
        dict(executor="carrier-pigeon"), dict(max_workers=0),
        dict(timeout=-1.0), dict(window=0),
        dict(executor="thread", hosts=["a:1"]), dict(executor="remote"),
        dict(executor="remote", hosts=["a:1"], agents=2),
        dict(executor="thread", mesh_spec=mesh),
        dict(executor="thread", autoscale=True),
        dict(executor="process", min_workers=2),
        dict(executor="process", autoscale=True, min_workers=9),
        dict(max_attempts=0), dict(on_failure="ignore"),
        dict(executor="process", liveness_timeout=0.0),
        dict(executor="process", speculate=0.5),
        dict(executor="thread", chaos=chaos),
        dict(executor="remote", hosts=["a:1"], max_respawns=2),
        dict(executor="process", max_respawns=-1),
        dict(executor="process", chaos="kill"),
        dict(executor="thread", dag=True),
    ]


def _build(pkg, kw):
    try:
        return dataclasses.asdict(PKG[pkg][1].FleetConfig(**kw))
    except (ValueError, TypeError) as e:
        return type(e).__name__


@pytest.mark.parametrize("case", range(len(_configs("torch"))))
def test_fleet_config_validates_like_reference(case):
    t = _build("torch", _configs("torch")[case])
    assert t == _build("jax", _configs("jax")[case])


def test_fleet_config_fold_and_constructors_like_reference():
    out = {}
    for pkg in PKG:
        F = PKG[pkg][1]
        res = [dataclasses.asdict(F.FleetConfig.fold(None, {}, caller="x"))]
        with pytest.warns(DeprecationWarning):
            res.append(dataclasses.asdict(F.FleetConfig.fold(
                None, {"executor": "process", "max_workers": 2,
                       "timeout": 9.0, "hosts": F.UNSET}, caller="x")))
        cfg = F.FleetConfig.process(max_workers=2, window=3)
        assert F.FleetConfig.fold(cfg, {"agents": F.UNSET},
                                  caller="x") is cfg
        with pytest.raises(ValueError, match="both"):
            F.FleetConfig.fold(cfg, {"max_workers": 2}, caller="x")
        with pytest.raises(TypeError, match="unknown"):
            F.FleetConfig.fold(None, {"wat": 1}, caller="x")
        with pytest.raises(TypeError):
            F.FleetConfig.fold("process", {}, caller="x")
        res += [dataclasses.asdict(c) for c in (
            F.FleetConfig.thread(3, window=4, on_failure="skip"),
            F.FleetConfig.process(2, autoscale=True, min_workers=1, dag=True),
            F.FleetConfig.remote(["h:1"], listen="0.0.0.0:1", agents=1))]
        back = pickle.loads(pickle.dumps(cfg))
        assert back == cfg
        with pytest.raises(ValueError, match="totals"):
            F.FleetConfig.process(dag=True).check_collect("totals")
        out[pkg] = res
    assert out["torch"] == out["jax"]


def test_worker_spec_names_the_device():
    em = _em("torch")
    cfg = TF.FleetConfig.process(liveness_timeout=2.0)
    assert TF.WorkerSpec(emulator=em.spec()).device == "cuda"
    spec = cfg.worker_spec(em.spec(), device="cpu")
    assert (spec.device, spec.heartbeat_s) == ("cpu", 0.5)
    r_spec = RF.FleetConfig.process(liveness_timeout=2.0).worker_spec(
        _em("jax").spec())
    assert r_spec.heartbeat_s == spec.heartbeat_s
    assert pickle.loads(pickle.dumps(spec)) == spec


# ---------------------------------------------------------------------------
# chaos streams
# ---------------------------------------------------------------------------

POLICIES = [dict(seed=11, kill_prob=0.3, delay_every=7, delay_s=0.5,
                 max_faults=5),
            dict(seed=4, kill_every=3, fail_nth=5, hang_nth=8, hang_s=0.2),
            dict(seed=0, drop_agent_after=3, corrupt_frame_nth=2),
            dict(seed=9, kill_prob=0.1, fail_nth=2, max_faults=0)]


@pytest.mark.parametrize("kw", POLICIES)
@pytest.mark.parametrize("scope", ["worker:0", "worker:7", "agent"])
def test_chaos_streams_equal_reference(kw, scope):
    streams = []
    for pkg in PKG:
        F = PKG[pkg][1]
        pol = pickle.loads(pickle.dumps(F.ChaosPolicy(**kw)))
        act, rep = pol.actor(scope), pol.actor(scope)
        streams.append((F.derive_seed(kw["seed"], scope), pol.active,
                        [act.on_dispatch() for _ in range(60)],
                        [rep.on_reply() for _ in range(20)], act.trace,
                        [pol.rng("coordinator").random() for _ in range(3)],
                        pol.corrupt_bytes(b"synapse-frame-payload")))
    assert streams[0] == streams[1]


# ---------------------------------------------------------------------------
# scheduler on in-process fake peers
# ---------------------------------------------------------------------------

def _fakes(pkg):
    """Loopback peer and fleet classes on one package's ``Peer`` and
    ``FleetBase``.  A peer built with a chaos actor consults it on every
    dispatch, as ``worker_loop`` does: ``kill`` drops the peer (its next
    ``recv`` raises ``PeerGone``), ``fail`` replies an error."""
    core, F, _, emu = PKG[pkg]

    class Echo(F.Peer):
        def __init__(self, scope, actor=None):
            super().__init__()
            self._r, self._w = mp.Pipe(duplex=False)
            self.ready = True
            self.scope = scope
            self.actor = actor
            self.dead = False

        @property
        def alive(self):
            return not self.dead

        @property
        def waitable(self):
            return self._r

        def dispatch(self, epoch, idx, bundle):
            self.tasks.add((epoch, idx))
            act = self.actor.on_dispatch() if self.actor else None
            if act == "kill":
                self.dead = True
                self._w.send(("gone",))
            elif act == "fail":
                self._w.send(("err", epoch, idx, "chaos: injected"))
            else:
                self._w.send(("ok", epoch, idx, emu.EmulationReport(
                    command=bundle.command, ttc_s=1e-3,
                    n_samples=bundle.n_profile_samples,
                    consumed=bundle.planned, mode="fused")))

        def recv(self):
            msg = self._r.recv()
            if msg[0] == "gone":
                raise F.PeerGone("chaos: killed")
            return msg

        def close(self):
            self._r.close()
            self._w.close()

    class Fleet(F.FleetBase):
        def __init__(self, n, *, chaos=None, autoscale=False, scale_max=3):
            super().__init__()
            self.chaos = chaos
            self._autoscale = autoscale
            self._scale_min = 1
            self._scale_max = scale_max
            self._spawned = 0
            for _ in range(n):
                self._add()

        def _add(self):
            scope = f"worker:{self._spawned}"
            self._spawned += 1
            self._peers.append(Echo(scope, self.chaos.actor(scope)
                                    if self.chaos else None))

        def _refill(self, pending):
            self._add()                      # an instant respawn

        def _scale_up(self):
            if len(self._peers) >= self._scale_max:
                return False
            self._add()
            self.scale_ups += 1
            return True

    def bundle(i, parents=()):
        # awkward float amounts: equal fold totals mean equal fold order
        return F.ScheduleBundle(
            command=f"b{i}", payload={}, n_profile_samples=1,
            planned=core.ResourceVector(flops=0.1 * i + 0.3,
                                        hbm_bytes=0.7 * i),
            parents=tuple(parents))

    return Fleet, bundle, emu.ReportFold


def _fold(fleet, bundles, **kw):
    """The stream's results in arrival order, holes as None."""
    return [(idx, None if rep is None else rep.consumed.to_dict())
            for idx, rep in fleet.stream(bundles, **kw)]


def test_chaos_event_sequence_equals_reference_on_fake_peers():
    runs = {}
    for pkg in PKG:
        Fleet, bundle, _ = _fakes(pkg)
        chaos = PKG[pkg][1].ChaosPolicy(seed=3, kill_every=3, fail_nth=2,
                                        max_faults=2)
        with Fleet(2, chaos=chaos) as fleet:
            got = _fold(fleet, [bundle(i) for i in range(12)], window=1,
                        on_failure="skip", timeout=60.0)
            rec = dict(fleet.last_recovery)
            runs[pkg] = (got, t_sequence(fleet.recorder.events())
                         if pkg == "torch"
                         else r_sequence(fleet.recorder.events()),
                         {k: rec[k] for k in ("worker_deaths", "requeued",
                                              "skipped")})
    assert runs["torch"] == runs["jax"]
    got, seq, rec = runs["torch"]
    assert rec["worker_deaths"] >= 2 and rec["skipped"]
    assert ("coordinator", "fault_opened", 1) in seq


@pytest.mark.parametrize("n", [1, 3])
def test_streamed_autoscale_totals_equal_fixed(n):
    totals = {}
    for pkg in PKG:
        Fleet, bundle, ReportFold = _fakes(pkg)
        folds = []
        for kw in (dict(n=3), dict(n=n, autoscale=True, scale_max=3)):
            fold = ReportFold()
            with Fleet(**kw) as fleet:
                src = (bundle(i) for i in range(30))   # a stream: no len()
                for idx, rep in fleet.stream(src, window=4):
                    fold.add(idx, rep)
            folds.append(fold.totals.to_dict())
            if kw.get("autoscale") and n == 1:
                assert fleet.last_scaling["scale_ups"] >= 1
        assert folds[0] == folds[1]
        totals[pkg] = folds[0]
    assert totals["torch"] == totals["jax"]


def test_dag_frontier_on_fake_peers_equals_reference():
    parents = {0: (), 1: (0,), 2: (0,), 3: (0,), 4: (1, 2, 3), 5: (4,)}
    runs = {}
    for pkg in PKG:
        Fleet, bundle, _ = _fakes(pkg)
        timings = {}
        with Fleet(3) as fleet:
            got = _fold(fleet, [bundle(i, parents[i]) for i in range(6)],
                        record_timing=timings.__setitem__)
            events = fleet.recorder.events()
        seq = (t_sequence if pkg == "torch" else r_sequence)(events)
        done = [e.get("idx") for e in events if e.kind == "done"]
        # no node dispatched before its parents' results landed
        for i, ps in parents.items():
            assert all(timings[p].done <= timings[i].dispatched for p in ps)
        cp = PKG[pkg][1].critical_path(parents, timings)
        runs[pkg] = (sorted(got), seq, done, cp["n_nodes"], cp["n_edges"])
    assert runs["torch"] == runs["jax"]


# ---------------------------------------------------------------------------
# thread fleet
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend,ref_backend,fused", [
    ("torch", "jnp", True), ("torch", "jnp", False),
    ("cuda", "pallas", False), ("cuda", "jnp", True)])
def test_thread_emulate_many_equals_reference(backend, ref_backend, fused,
                                              tmp_path):
    # the reference's pallas memory leg cannot run (ROADMAP.md queue 3)
    compute_only = ref_backend == "pallas"
    out = {}
    for pkg, b in (("torch", backend), ("jax", ref_backend)):
        em = _em(pkg, tmp_path, backend=b)
        cfg = PKG[pkg][1].FleetConfig.thread(max_workers=2)
        launches = (tck.launches, tck.iterations, tmk.launches)
        rep = em.emulate_many(_jobs(pkg, compute_only), config=cfg,
                              fused=fused)
        if pkg == "torch":
            # CPU tensors: the kernels' plain versions, never a launch
            assert (tck.launches, tck.iterations, tmk.launches) == launches
        out[pkg] = (rep.totals.to_dict(), rep.n_samples, rep.n_replayed,
                    rep.max_workers, rep.cache_stats,
                    [_report_dump(r) for r in rep.reports])
    assert out["torch"] == out["jax"]
    jobs = _jobs("torch", compute_only)
    assert [r["consumed"] for r in out["torch"][5]] == \
        [p.totals.to_dict() for p in jobs]


def test_thread_fleet_cuda_backend_matches_torch_backend(tmp_path):
    """The kernel backend (plain versions on the CPU) replays the full job
    set, memory legs included, fused through the segment kernel's wrapper
    to the same totals as the ``"torch"`` backend."""
    reps = [_em("torch", tmp_path, backend=b).emulate_many(
        _jobs("torch"), config=TF.FleetConfig.thread(max_workers=2))
        for b in ("cuda", "torch")]
    assert reps[0].totals == reps[1].totals
    assert [r.mode for r in reps[0].reports] == ["fused"] * 5


def test_thread_fleet_skip_window_and_errors_like_reference(tmp_path):
    out = {}
    for pkg in PKG:
        core, F, S, _ = PKG[pkg]
        em = _em(pkg, tmp_path)
        good = _jobs(pkg)[:3]
        # fails inside the pool thread (resources=None breaks compile)
        bad = core.SynapseProfile(command="bad", samples=[core.Sample(
            index=0, resources=None)])
        rep = em.emulate_many(good[:1] + [bad] + good[1:],
                              config=F.FleetConfig.thread(
                                  2, window=1, on_failure="skip"),
                              collect="totals")
        with pytest.raises(ValueError, match="collect"):
            em.emulate_many(good, collect="everything")
        with pytest.raises(ValueError, match="frontier"):
            em.emulate_many(S.fork_join(good[0], good[1:2], good[2]),
                            config=F.FleetConfig.thread())
        with pytest.raises(ValueError):
            em.emulate_many(good, config=F.FleetConfig.process(),
                            fused=False)
        with pytest.raises(TimeoutError):
            em.emulate_many(good, config=F.FleetConfig.thread(timeout=0.0))
        out[pkg] = (rep.totals.to_dict(), rep.recovery, rep.n_replayed,
                    rep.reports)
    assert out["torch"] == out["jax"]
    assert out["torch"][1] == {"skipped": [1]}


def test_unported_fleet_paths_raise_not_implemented():
    em = _em("torch")
    jobs = _jobs("torch")[:1]
    # the remote executor is ported: its config builds a RemoteFleet
    # (listening on a free port here, so nothing is dialled)
    spec = TF.FleetConfig.remote(listen="127.0.0.1:0").worker_spec(
        em.spec(), device="cpu")
    with TF.FleetConfig.remote(listen="127.0.0.1:0").build(spec) as fleet:
        assert isinstance(fleet, TF.RemoteFleet)
        assert fleet.spec.device == "cpu" and fleet.bound_addr[1] > 0
    # meshes are ported: test_mesh_spec_builds_a_shared_mesh_for_workers
    # below, and test_torch_collectives.py replays mesh-bound bundles on
    # process and remote fleets
    # the kernel backend replays per sample at a tile the segment kernel
    # does not take, and ships no compiled tables there: processes refuse it
    off_tile = T.Emulator(calib=T.HostCalibration(1e9, 1e9, 1e8, 1e8),
                          backend="cuda", compute_tile=32, mem_block=BLOCK,
                          device="cpu")
    with pytest.raises(ValueError, match="fused"):
        off_tile.emulate_many(jobs, config=TF.FleetConfig.process())



def test_mesh_spec_builds_a_shared_mesh_for_workers():
    """A MeshSpec builds a live mesh on the device it is given, every shard
    there, and a process config ships it to its workers, whose emulators
    quantize wire bytes for it."""
    mesh = TF.MeshSpec(shape=(2,), axes=("model",))
    assert mesh.device_count == 2
    live = mesh.build("cpu")
    assert live.shared and live.shape == {"model": 2}
    assert list(live.devices.flat) == [torch.device("cpu")] * 2
    wspec = TF.FleetConfig.process(mesh=mesh).worker_spec(_em("torch").spec(),
                                                          device="cpu")
    assert wspec.mesh == mesh and wspec.device == "cpu"
    twin = wspec.emulator.build(mesh=live, device="cpu")
    assert twin.collective.quant() == T.CollectiveQuant(n=2)

def test_fleet_report_json_crosses_both_ways():
    reps = {}
    for pkg in PKG:
        core, F, _, emu = PKG[pkg]
        tm = {0: F.BundleTiming(0.0, 0.0, 1.0, 0.0, 1.0, 1, True),
              1: F.BundleTiming(0.0, 1.0, 2.5, 1.0, 1.5, 2, True)}
        reps[pkg] = emu.FleetReport(
            reports=[emu.EmulationReport(
                command="c", ttc_s=0.5, n_samples=2,
                consumed=core.ResourceVector(flops=FPI, hbm_bytes=BPI),
                per_sample_s=[0.2, 0.3], mode="fused", n_dispatches=1)],
            wall_s=1.5, serial_s=3.0, max_workers=2,
            cache_stats={"plans_built": 1, "hits": 2, "size": 1},
            totals=core.ResourceVector(flops=FPI, hbm_bytes=BPI),
            n_samples=2, n_replayed=1, scaling={"peak_workers": 2},
            recovery={"worker_deaths": 1, "fault_events": [(0.5, 0.9)]},
            obs={"schema": 1, "events": []},
            dag=F.critical_path({0: (), 1: (0,)}, tm))
    t_json = json.dumps(reps["torch"].to_json())
    r_json = json.dumps(reps["jax"].to_json())
    assert t_json == r_json
    for text, emu in ((t_json, r_emulator), (r_json, t_emulator)):
        back = emu.FleetReport.from_json(json.loads(text))
        assert json.dumps(back.to_json()) == t_json
        assert back.dag["slack_s"] == {0: 0.0, 1: 0.0}
        assert back.summary()["critical_path_s"] == 2.5


# ---------------------------------------------------------------------------
# process fleet (spawns real CPU workers; at most 2 each)
# ---------------------------------------------------------------------------

@pytest.fixture
def one_thread(monkeypatch):
    """Spawned CPU workers run torch on one intra-op thread: two workers
    of 8 spinning threads each on a shared host replay tiny tiles an order
    of magnitude slower."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")

def test_process_fleet_bit_identical_to_reference_replay(tmp_path, one_thread):
    r_em, t_em = _em("jax", tmp_path), _em("torch", tmp_path)
    refs = [r_em.emulate(p, fused=True) for p in _jobs("jax")]
    r_em.storage.cleanup()
    fleet = t_em.emulate_many(_jobs("torch"),
                              config=TF.FleetConfig.process(max_workers=2))
    assert fleet.n_profiles == 5 and fleet.max_workers == 2
    assert fleet.cache_stats["worker_deaths"] == 0
    for ref, rep in zip(refs, fleet.reports):
        assert rep.mode == "fused"
        assert _report_dump(rep) == _report_dump(ref)
    want = R.ResourceVector()
    for ref in refs:                   # the fold's order: profile order
        want = want.add(ref.consumed)
    assert fleet.totals.to_dict() == want.to_dict()
    # the report loads in the reference and back
    back = r_emulator.FleetReport.from_json(
        json.loads(json.dumps(fleet.to_json())))
    assert json.dumps(back.to_json()) == json.dumps(fleet.to_json())


def test_reference_payload_replays_on_a_port_worker(tmp_path, one_thread):
    """A bundle whose schedule was compiled and detached by the JAX
    package replays on a port worker to the reference's totals."""
    r_em, t_em = _em("jax", tmp_path), _em("torch", tmp_path)
    jobs = _jobs("jax")
    r_bundles = [RF.bundle_profile(r_em, p) for p in jobs]
    refs = [r_em.replay(b.rehydrate(), command=b.command, planned=b.planned)
            for b in r_bundles]
    r_em.storage.cleanup()
    bundles = [TF.ScheduleBundle(command=b.command, payload=b.payload,
                                 n_profile_samples=b.n_profile_samples,
                                 planned=T.ResourceVector.from_dict(
                                     b.planned.to_dict()))
               for b in pickle.loads(pickle.dumps(r_bundles))]
    with TF.ProcessFleet(1, TF.WorkerSpec(emulator=t_em.spec(),
                                          device="cpu")) as pf:
        info, = pf.warmup()
        assert info["device"] == "cpu" and info["mesh"] is None
        assert info["devices"] == torch.cuda.device_count()
        reports = pf.run(bundles)
    assert [_report_dump(r) for r in reports] == \
        [_report_dump(r) for r in refs]


def test_process_fleet_survives_sigkill(tmp_path, one_thread):
    em = _em("torch", tmp_path)
    jobs = _jobs("torch")
    bundles = [TF.bundle_profile(em, p) for p in jobs]
    want = [em.emulate(p).consumed for p in jobs]
    em.storage.cleanup()
    with TF.ProcessFleet(2, TF.WorkerSpec(emulator=em.spec(),
                                          device="cpu")) as pf:
        pf.warmup()
        os.kill(pf.pids[0], signal.SIGKILL)          # one worker dies
        reports = pf.run(bundles)
        assert pf.worker_deaths >= 1 and pf.respawns >= 1
        assert [r.consumed for r in reports] == want  # nothing lost
        bad = TF.ScheduleBundle(command="bad", payload={"version": 99})
        with pytest.raises(RuntimeError, match="bad"):
            pf.run([bad] + bundles[:1])
        assert pf.run(bundles[:2])[1].consumed == want[1]


def test_dag_with_chaos_on_process_fleet(tmp_path, one_thread):
    """A fork-join DAG through 2 workers, one killed by a seeded chaos
    policy: every node replays exactly once to the reference's totals,
    no child starts before its parents, and ``FleetReport.dag`` is the
    critical path of the run's own stamps."""
    r_em, t_em = _em("jax", tmp_path), _em("torch", tmp_path)
    r_jobs, t_jobs = _jobs("jax"), _jobs("torch")
    r_dag = RS.fork_join(r_jobs[0], r_jobs[1:4], r_jobs[4])
    dag = TS.fork_join(t_jobs[0], t_jobs[1:4], t_jobs[4])
    refs = [r_em.emulate(p, fused=True) for p in r_dag.profiles()]
    r_em.storage.cleanup()
    rep = t_em.emulate_many(dag, config=TF.FleetConfig.process(
        max_workers=2, chaos=TF.ChaosPolicy(seed=0, kill_every=2,
                                            max_faults=1), max_respawns=8))
    assert rep.recovery["worker_deaths"] >= 1
    assert [_report_dump(r) for r in rep.reports] == \
        [_report_dump(r) for r in refs]
    assert rep.totals.to_dict() == r_dag.totals.to_dict()
    assert rep.dag["n_nodes"] == 5 and rep.dag["n_edges"] == 6
    assert rep.dag["critical_nodes"][0] == 0
    assert rep.dag["critical_nodes"][-1] == 4


def test_init_failure_reports_the_worker_traceback():
    """The normalized init error is ("err", epoch, None, traceback,
    frame).  The JAX package's ``warmup`` prints its last field, the
    frame (None); the port prints the traceback."""
    msgs = {}
    for pkg in PKG:
        F = PKG[pkg][1]

        class Broken(F.Peer):
            def __init__(self):
                super().__init__()
                self._r, self._w = mp.Pipe(duplex=False)
                self._w.send(None)

            @property
            def waitable(self):
                return self._r

            def recv(self):
                self._r.recv()
                return ("err", None, None, "Traceback: no card", None)

            def close(self):
                self._r.close()
                self._w.close()

        class Pool(F.FleetBase):
            def __init__(self):
                super().__init__()
                self._peers.append(Broken())

        with Pool() as pool:
            with pytest.raises(RuntimeError) as e:
                pool.warmup(timeout=10.0)
        msgs[pkg] = str(e.value)
    assert msgs["torch"].endswith("Traceback: no card")
    assert msgs["jax"].endswith("None")


def test_cuda_worker_without_a_card_raises_instead_of_replaying(one_thread):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: a cuda worker is valid here")
    em = _em("torch")
    with TF.ProcessFleet(1, TF.WorkerSpec(emulator=em.spec(),
                                          device="cuda",
                                          warmup=False)) as pf:
        with pytest.raises(RuntimeError, match="CUDA"):
            pf.warmup(timeout=120.0)

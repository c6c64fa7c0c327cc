"""The port's collective atom and meshes against the JAX package's.

Ports each of the 11 tests of ``tests/test_collectives_fused.py`` and the
collective parity cases of ``tests/test_fleet.py`` and
``tests/test_dag.py``.  The JAX package's meshes need forced host devices,
so its side runs once, in a subprocess started with
``--xla_force_host_platform_device_count=4`` (a 2-device mesh takes the
first two; the (2, 2) mesh all four): it writes its results into a pickle
that the tests here compare with the port, in this process, on the port's
meshes, whose shards all live on the CPU.  Compared: the loop body and the
per-sample collective of every kind over k = 1 and k = 7 steps (within
1e-6 relative, float32), plan keys and quantized amounts, compiled
tables, the equivalence contract of the three replay paths, the plan
cache's quantized amounts and tiny-leg clamp, and mesh-bound payloads
both ways.  The fleet tests spawn at most 2 CPU workers (and one agent),
each pinned to one OMP thread.
"""
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import repro.core as R
import repro.fleet as RF
import repro_torch.core as T
import repro_torch.fleet as TF
import repro.scenarios as RS
import repro_torch.scenarios as TS
from repro.core.schedule import BarrierStep as RBarrierStep
from repro.obs import FlightRecorder as RFlightRecorder
from repro.obs import to_chrome_trace as r_chrome_trace
from repro_torch.core.atoms import COLL_BLOCK_ELEMS, CollectiveAtom
from repro_torch.core.hardware import REGISTRY
from repro_torch.core.schedule import BarrierStep, FusedSegment
from repro_torch.kernels.collective import kernel as tck
from repro_torch.kernels.collective import ref as tcref
from repro_torch.kernels.segment import kernel as tsk
from repro_torch.launch.mesh import describe, make_mesh
from repro_torch.obs import FlightRecorder, to_chrome_trace, validate_trace

TILE = 64                  # 1 compute iter = 2*64^3  = 524288 flops
BLOCK = 1 << 18            # 1 memory  iter = 2*2^18  = 524288 bytes
FPI = 2.0 * TILE ** 3
BPI = 2.0 * BLOCK
WPI = 4.0 * COLL_BLOCK_ELEMS   # n=2 all-reduce: factor 1.0 * 4 bytes/elem
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
RTOL = 1e-6                # float32 collectives, sums in one order or two
BLK = 16                   # per-shard floats of the numeric cases

# (id, mesh shape, axes, collective axis, kind)
NUMERIC = [
    ("ar", (2,), ("model",), "model", "all-reduce"),
    ("ag", (2,), ("model",), "model", "all-gather"),
    ("cp", (2,), ("model",), "model", "collective-permute"),
    ("ar-data", (2, 2), ("data", "model"), "data", "all-reduce"),
    ("ar-model", (2, 2), ("data", "model"), "model", "all-reduce"),
]
STEPS = (1, 7)
# (id, mesh shape, axes, axis, kind, wire bytes) whose plan keys are held
# against the reference's; n == 1 all-reduce/all-gather is pinned apart
KEY_MESHES = [((2,), ("model",), "model"), ((4,), ("model",), "model"),
              ((2, 2), ("data", "model"), "data"), ((1,), ("model",), "model")]
KEY_AMOUNTS = (10.0, 1e3, 4e6, 4e6 + 2.0, 1.52e10)
KINDS = ("all-reduce", "all-gather", "collective-permute")


def _rv(pkg, flops=0.0, hbm=0.0, sw=0.0, sr=0.0, ici=0.0):
    return pkg.ResourceVector(flops=flops, hbm_bytes=hbm,
                              storage_write_bytes=sw, storage_read_bytes=sr,
                              ici_bytes={"all-reduce": ici} if ici else {})


def _profile(pkg, rvs, command="coll-test"):
    return pkg.SynapseProfile(command=command, samples=[
        pkg.Sample(index=i, resources=_rv(pkg, **r))
        for i, r in enumerate(rvs)])


# profiles as plain amounts, built by each package (and the subprocess)
PROFILES = {
    "wire_heavy": [{"flops": FPI, "hbm": BPI, "ici": 4e6},
                   {"flops": 2 * FPI}, {"ici": 2e6},
                   {"flops": FPI, "sw": 2 << 20, "ici": 1e6},
                   {"hbm": BPI, "ici": 4e6}],
    # alternating wire amounts so _collapse merges nothing, one storage
    # sample so the wire-bearing barrier path is exercised too
    "equiv": ([{"flops": (1 + i % 2) * FPI, "ici": (1 + i % 2) * 2e6}
               for i in range(8)]
              + [{"flops": FPI, "sw": 2 << 20, "ici": 1e6}]
              + [{"flops": (1 + i % 2) * FPI, "ici": (1 + i % 2) * 2e6}
                 for i in range(8, 16)]),
    "tiny": [{"flops": FPI, "ici": 10.0}],
    "collapse": [{"flops": FPI, "hbm": BPI, "ici": 3e5}] * 6
    + [{"ici": 7.5e5}, {"hbm": 3 * BPI, "ici": 0.4 * WPI}],
    "training": [{"flops": 4e7, "hbm": 2e6, "ici": 4e6}] * 3
    + [{"flops": 4e7, "hbm": 2e6, "ici": 4e6, "sw": 2 << 20}],
}
# (mesh shape, axes, collective spec kind) of the compiled-table cases
TABLE_MESHES = [((2,), ("model",), "all-reduce"),
                ((4,), ("model",), "all-reduce"),
                ((2,), ("model",), "all-gather"),
                ((4,), ("model",), "collective-permute"),
                ((1,), ("model",), "all-reduce")]


def _em(pkg, tmp_path=None, **kw):
    extra = {"device": "cpu"} if pkg is T else {}
    em = pkg.Emulator(calib=pkg.HostCalibration(1e9, 1e9, 1e8, 1e8),
                      compute_tile=TILE, mem_block=BLOCK, **extra, **kw)
    if tmp_path is not None:
        em.storage.dir = str(tmp_path)
    return em


def _mesh_em(tmp_path=None, shape=(2,), axes=("model",), kind=None,
             **kw):
    em = _em(T, tmp_path, mesh=make_mesh(shape, axes, "cpu"), **kw)
    if kind is not None:
        em.attach_collective(T.CollectiveSpec(kind=kind).build(
            em.collective.mesh, backend=em.compute.backend))
    return em


def _dump(rep):
    """A report without its wall-clock fields."""
    d = rep.to_dict()
    d.pop("ttc_s")
    d.pop("per_sample_s")
    return d


def _shards(x_glob, shape, axes, axis):
    """The reference's global operand, sharded along ``axis`` and
    replicated across the mesh's other axes, as the port's shards tensor
    (*shape, block)."""
    dim = axes.index(axis)
    n = shape[dim]
    blocks = torch.tensor(x_glob).reshape(n, -1)       # a copy: the loop
    view = [1] * len(shape) + [blocks.shape[1]]       # steps in place
    view[dim] = n
    return blocks.reshape(view).expand(*shape, blocks.shape[1]).contiguous()


def _along_axis(t, axes, axis):
    """Every replica of the shards tensor along the mesh's other axes, as
    (replicas, n, block) with the collective axis second."""
    dim = axes.index(axis)
    t = t.movedim(dim, 0)
    return t.reshape(t.shape[0], -1, t.shape[-1]).movedim(0, 1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """This module's CPU replays are tiny: run them on one intra-op thread,
    so that beside the suite's other workers they do not oversubscribe the
    host."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ---------------------------------------------------------------------------
# the JAX package's side, once, in a subprocess with 4 host devices
# ---------------------------------------------------------------------------

REFERENCE = r'''
import pickle, sys
import numpy as np
import jax
from repro.core import (CollectiveSpec, Emulator, HostCalibration,
                        PlanCache, ResourceVector, Sample, SynapseProfile,
                        rehydrate_schedule)
from repro.core.atoms import CollectiveAtom

inp = pickle.load(open(sys.argv[1], "rb"))
out = {}

def rv(flops=0.0, hbm=0.0, sw=0.0, sr=0.0, ici=0.0):
    return ResourceVector(flops=flops, hbm_bytes=hbm,
                          storage_write_bytes=sw, storage_read_bytes=sr,
                          ici_bytes={"all-reduce": ici} if ici else {})

def profile(rvs, command="coll-test"):
    return SynapseProfile(command=command, samples=[
        Sample(index=i, resources=rv(**r)) for i, r in enumerate(rvs)])

def emulator(shape=(2,), axes=("model",), kind=None, cache=None):
    em = Emulator(calib=HostCalibration(1e9, 1e9, 1e8, 1e8),
                  compute_tile=64, mem_block=1 << 18,
                  mesh=jax.make_mesh(shape, axes), plan_cache=cache)
    if kind is not None:
        em.attach_collective(CollectiveSpec(kind=kind).build(
            em.collective.mesh))
    em.storage.dir = inp["dir"]
    return em

def dump(rep):
    d = rep.to_dict()
    d.pop("ttc_s")
    d.pop("per_sample_s")
    return d

# loop body and per-sample collective, k steps
num = {}
for (cid, shape, axes, axis, kind), x in inp["numeric"]:
    atom = CollectiveAtom(jax.make_mesh(shape, axes), axis=axis, kind=kind)
    body = atom.loop_body()
    for k in inp["steps"]:
        y = x
        for _ in range(k):
            y = np.asarray(body(y))
        z = x
        for _ in range(k):
            z = np.asarray(atom._coll_fn(z.size)(z)).reshape(-1)
        num[(cid, k)] = (y, z)
out["numeric"] = num

# plan keys and quantized amounts, read through a cache that builds nothing
class Grab:
    def get_or_build(self, key, builder):
        return key

keys = {}
for shape, axes, axis in inp["key_meshes"]:
    mesh = jax.make_mesh(shape, axes)
    for kind in inp["kinds"]:
        atom = CollectiveAtom(mesh, axis=axis, kind=kind)
        atom.cache = Grab()
        for w in inp["key_amounts"]:
            key = atom.plan(w)
            keys[(shape, axis, kind, w)] = (
                key, atom.quantized_wire_bytes(key[-1]))
out["keys"] = keys

# compiled tables on a live mesh
tables = {}
for shape, axes, kind in inp["table_meshes"]:
    em = emulator(shape, axes, kind)
    for name, rvs in inp["profiles"].items():
        tables[(shape, kind, name)] = em.compile(profile(rvs)).detach()
out["tables"] = tables

# the equivalence contract on the 2-device mesh
em = emulator()
prof = profile(inp["profiles"]["equiv"], "equiv")
out["equiv"] = {
    "fused": dump(em.emulate(prof, fused=True)),
    "per_sample": dump(em.emulate(prof, fused=False)),
    "barrier": dump(em.replay(em.compile(prof, keep_collectives=True),
                              command="equiv", planned=prof.totals))}

# plan-cache sharers and the tiny clamp
em = emulator(cache=PlanCache())
atom = em.collective
first, second = atom.plan(4e6 + 2.0), atom.plan(4e6)
tiny = atom.plan(10.0)
tprof = profile(inp["profiles"]["tiny"], "tiny")
out["sharers"] = {
    "amounts": (first.amount, second.amount, tiny.amount),
    "hits": em.plan_cache.stats()["hits"],
    "barrier": dump(em.replay(em.compile(tprof, keep_collectives=True),
                              command="tiny")),
    "fused": dump(em.emulate(tprof, fused=True))}

# mesh-bound payloads both ways
em = emulator()
wprof = profile(inp["profiles"]["wire_heavy"])
sched = em.compile(wprof)
out["payload"] = sched.detach()
out["payload_replay"] = dump(em.replay(sched, command="coll-test",
                                       planned=wprof.totals))
out["port_payload_replay"] = dump(em.replay(
    rehydrate_schedule(inp["port_payload"]), command="coll-test",
    planned=wprof.totals))
em.storage.cleanup()
pickle.dump(out, open(sys.argv[2], "wb"))
print("OK reference")
'''


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX package's results (see ``REFERENCE``)."""
    d = tmp_path_factory.mktemp("coll_ref")
    rng = np.random.default_rng(17)
    numeric = [((cid, shape, axes, axis, kind),
                rng.standard_normal(shape[axes.index(axis)] * BLK)
                .astype(np.float32))
               for cid, shape, axes, axis, kind in NUMERIC]
    em = _mesh_em(d)
    port_payload = em.compile(_profile(T, PROFILES["wire_heavy"])).detach()
    inp = {"numeric": numeric, "steps": STEPS, "key_meshes": KEY_MESHES,
           "kinds": KINDS, "key_amounts": KEY_AMOUNTS,
           "table_meshes": TABLE_MESHES, "profiles": PROFILES,
           "port_payload": port_payload, "dir": str(d)}
    with open(d / "in.pkl", "wb") as f:
        pickle.dump(inp, f)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    res = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(REFERENCE), str(d / "in.pkl"),
         str(d / "out.pkl")], capture_output=True, text=True, env=env,
        timeout=560)
    assert res.returncode == 0, res.stdout + "\n" + res.stderr
    with open(d / "out.pkl", "rb") as f:
        out = pickle.load(f)
    out["inputs"] = {case[0]: x for case, x in numeric}
    return out


# ---------------------------------------------------------------------------
# quantization (meshless) — tests/test_collectives_fused.py, ported
# ---------------------------------------------------------------------------

def test_collective_quant_math():
    for pkg in (T, R):
        q = pkg.CollectiveQuant(n=2, kind="all-reduce")
        assert q.factor == pkg.collective_factor("all-reduce", 2) == 1.0
        assert q.wire_bytes_per_iter == WPI
        assert q.iters_for(4e6) == round(4e6 / WPI)
        assert q.iters_for(0.4 * WPI) == 0
        assert q.iters_for(-1.0) == 0
        assert q.emulated_bytes(3) == 3 * WPI
        assert pkg.CollectiveQuant(n=4, kind="all-gather").factor == 0.75
        assert pkg.CollectiveQuant(n=4,
                                   kind="collective-permute").factor == 1.0
        assert pkg.CollectiveQuant(n=1).iters_for(1e12) == 0
        assert pkg.CollectiveQuant.from_dict(q.to_dict()) == q
    assert T.CollectiveQuant(n=2).to_dict() == R.CollectiveQuant(n=2).to_dict()


def test_quant_for_mesh_spec_matches_live_mesh_quant():
    spec = T.CollectiveSpec()
    mesh_spec = TF.MeshSpec(shape=(2,), axes=("model",))
    assert spec.quant_for(mesh_spec) == T.CollectiveQuant(n=2)
    assert spec.quant_for(mesh_spec) == spec.build(
        mesh_spec.build("cpu")).quant()
    two_axis = TF.MeshSpec(shape=(2, 4), axes=("data", "model"))
    assert spec.quant_for(two_axis).n == 4
    assert T.CollectiveSpec(axis="data").quant_for(two_axis).n == 2
    assert T.CollectiveSpec(axis="data").build(
        two_axis.build("cpu")).quant().n == 2
    with pytest.raises(ValueError, match="not in mesh axes"):
        T.CollectiveSpec(axis="pipeline").quant_for(two_axis)
    r_two = RF.MeshSpec(shape=(2, 4), axes=("data", "model"))
    for axis in (None, "data", "model"):
        assert T.CollectiveSpec(axis=axis).quant_for(two_axis).to_dict() \
            == R.CollectiveSpec(axis=axis).quant_for(r_two).to_dict()


def test_meshless_parent_compiles_mesh_bound_segments():
    em, r_em = _em(T), _em(R)
    sched = em.compile(_profile(T, PROFILES["wire_heavy"]),
                       mesh_spec=TF.MeshSpec(shape=(2,), axes=("model",)))
    r_sched = r_em.compile(_profile(R, PROFILES["wire_heavy"]),
                           mesh_spec=RF.MeshSpec(shape=(2,),
                                                 axes=("model",)))
    assert [type(s) for s in sched.steps] == \
        [FusedSegment, BarrierStep, FusedSegment]
    assert sched.mesh_bound
    assert sched.collective_quant == T.CollectiveQuant(n=2)
    q = sched.collective_quant
    want = [(em.compute.iters_for(FPI), em.memory.iters_for(BPI),
             q.iters_for(4e6)),
            (em.compute.iters_for(2 * FPI), 0, 0),
            (0, 0, q.iters_for(2e6))]
    assert [tuple(r) for r in sched.segments[0].table] == want
    assert sched.segments[1].table[0, 2] == q.iters_for(4e6)
    for a, b in zip(sched.segments, r_sched.segments):
        np.testing.assert_array_equal(a.table, b.table)
    kept = em.compile(_profile(T, PROFILES["wire_heavy"]),
                      keep_collectives=True)
    assert sum(isinstance(s, BarrierStep) for s in kept.steps) == 4
    assert not kept.mesh_bound and kept.collective_quant is None
    folded = em.compile(_profile(T, PROFILES["wire_heavy"]))
    assert not folded.mesh_bound
    assert all(int(s.table[:, 2].sum()) == 0 for s in folded.segments)


def test_mesh_bound_bundle_roundtrips_through_pickle():
    em = _em(T)
    mesh_spec = TF.MeshSpec(shape=(2,), axes=("model",))
    prof = _profile(T, PROFILES["wire_heavy"])
    sched = em.compile(prof, mesh_spec=mesh_spec)
    bundle = pickle.loads(pickle.dumps(
        TF.bundle_profile(em, prof, mesh_spec=mesh_spec)))
    back = bundle.rehydrate()
    assert back.mesh_bound
    assert back.collective_quant == sched.collective_quant
    for a, b in zip(sched.steps, back.steps):
        if isinstance(a, FusedSegment):
            np.testing.assert_array_equal(a.table, b.table)
            assert a.rows == b.rows
        else:
            assert a.resources == b.resources and a.count == b.count


def test_version1_payload_loads_with_zero_wire_column():
    em = _mesh_em()
    prof = _profile(T, [{"flops": FPI}, {"hbm": BPI}])
    payload = em.compile(prof).detach()
    assert payload["version"] == 2
    legacy = {"version": 1,
              "steps": [{"kind": "segment",
                         "table": payload["steps"][0]["table"][:, :2],
                         "rows": payload["steps"][0]["rows"]}]}
    back = T.rehydrate_schedule(legacy)
    seg = back.segments[0]
    assert seg.table.shape == (2, 3)
    assert seg.collective_iters == 0 and not seg.mesh_bound
    assert em.replay(back, command="v1").consumed == prof.totals


def test_meshless_replay_of_mesh_bound_schedule_raises():
    em = _em(T)
    sched = em.compile(_profile(T, [{"ici": 4e6}]),
                       mesh_spec=TF.MeshSpec(shape=(2,), axes=("model",)))
    assert sched.mesh_bound
    with pytest.raises(RuntimeError, match="mesh"):
        em.replay(sched, command="meshless")


def test_folded_wire_reports_zero_emulated_ici():
    reps = {}
    for pkg in (T, R):
        rep = _em(pkg).emulate(_profile(pkg, [{"flops": FPI, "ici": 4e6}]),
                               fused=True)
        assert rep.consumed.ici_total == 4e6
        assert rep.emulated_ici_bytes == 0.0
        assert rep.n_collective_dispatches == 0
        assert rep.summary()["emulated_ici_bytes"] == 0.0
        reps[pkg] = _dump(rep)
    assert reps[T] == reps[R]


# ---------------------------------------------------------------------------
# mesh equivalence — on the port's 2-shard mesh, against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_fused_barrier_and_per_sample_replay_are_equivalent(
        backend, reference, tmp_path):
    em = _mesh_em(tmp_path, backend=backend)
    prof = _profile(T, PROFILES["equiv"], "equiv")
    fused = em.emulate(prof, fused=True)
    per_sample = em.emulate(prof, fused=False)
    barrier = em.replay(em.compile(prof, keep_collectives=True),
                        command="equiv", planned=prof.totals)
    em.storage.cleanup()
    assert fused.mode == "fused" and per_sample.mode == "per_sample"
    assert fused.consumed == per_sample.consumed == barrier.consumed \
        == prof.totals
    assert fused.n_samples == per_sample.n_samples == barrier.n_samples
    assert fused.n_collective_dispatches == 17
    assert per_sample.n_collective_dispatches == 17
    assert barrier.n_collective_dispatches == 17
    assert fused.n_dispatches == 4
    assert per_sample.n_dispatches == barrier.n_dispatches == 34
    for name, rep in (("fused", fused), ("per_sample", per_sample),
                      ("barrier", barrier)):
        assert abs(rep.emulated_ici_bytes - prof.totals.ici_total) \
            < 0.05 * prof.totals.ici_total, rep.emulated_ici_bytes
        assert _dump(rep) == reference["equiv"][name]


def test_plan_cache_sharers_report_quantized_amount_and_tiny_clamp(
        reference, tmp_path):
    em = _mesh_em(tmp_path, plan_cache=T.PlanCache())
    atom = em.collective
    first = atom.plan(4e6 + 2.0)
    second = atom.plan(4e6)
    assert em.plan_cache.stats()["hits"] == 1
    assert first.amount == second.amount == 4e6
    tiny = atom.plan(10.0)
    assert tiny.amount == 8.0
    assert tiny() == 8.0
    ref = reference["sharers"]
    assert (first.amount, second.amount, tiny.amount) == ref["amounts"]
    assert ref["hits"] == 1
    prof = _profile(T, PROFILES["tiny"], "tiny")
    rep = em.replay(em.compile(prof, keep_collectives=True), command="tiny")
    assert rep.consumed.ici_total == 10.0
    assert rep.emulated_ici_bytes == 8.0
    assert rep.summary()["emulated_ici_bytes"] == 8.0
    assert rep.n_collective_dispatches == 1
    assert _dump(rep) == ref["barrier"]
    fused_tiny = em.emulate(prof, fused=True)
    assert fused_tiny.consumed == rep.consumed
    assert fused_tiny.n_collective_dispatches == 0
    assert fused_tiny.emulated_ici_bytes == 0.0
    assert _dump(fused_tiny) == ref["fused"]
    # a mesh-owning parent bundling for workers of UNKNOWN mesh ships
    # portable barrier steps, never its own mesh's quantization
    bprof = _profile(T, [{"ici": 4e6}], "own-mesh")
    shipped = TF.bundle_profile(em, bprof).rehydrate()
    assert not shipped.mesh_bound
    assert any(isinstance(s, BarrierStep) for s in shipped.steps)
    # attach_collective drops the runner's carry: it lies on the previous
    # atom's mesh
    em.replay(em.compile(bprof), command="warm-coll")
    assert em._segments._xcoll is not None
    em.attach_collective(em.collective)
    assert em._segments._xcoll is None
    # a schedule quantized for a 4-way mesh must not replay on this 2-way
    sched = em.compile(bprof, mesh_spec=TF.MeshSpec(shape=(4,),
                                                    axes=("model",)))
    assert sched.mesh_bound
    with pytest.raises(RuntimeError, match="quantized for"):
        em.replay(sched, command="skewed")


# ---------------------------------------------------------------------------
# numerics, keys, tables and payloads against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("k", STEPS)
@pytest.mark.parametrize("case", NUMERIC, ids=[c[0] for c in NUMERIC])
def test_loop_body_matches_reference(case, k, backend, reference):
    cid, shape, axes, axis, kind = case
    atom = CollectiveAtom(make_mesh(shape, axes, "cpu"), axis=axis,
                          kind=kind, backend=backend)
    body = atom.loop_body()
    n = shape[axes.index(axis)]
    # the loop body runs on the segment's (n, block) carry
    carry = torch.tensor(reference["inputs"][cid]).reshape(n, -1)
    for _ in range(k):
        carry = body(carry)
    want = reference["numeric"][(cid, k)][0].reshape(n, -1)
    np.testing.assert_allclose(carry.numpy(), want, rtol=RTOL, atol=0)
    # and along any axis of the mesh's shards tensor, every replica alike
    x = _shards(reference["inputs"][cid], shape, axes, axis)
    for _ in range(k):
        x = tcref.loop_step(x, dim=axes.index(axis), kind=kind)
    for rep in _along_axis(x, axes, axis).unbind(0):
        np.testing.assert_allclose(rep.numpy(), want, rtol=RTOL, atol=0)
    # the "cuda" runner steps the carry inside the segment wrapper: k
    # steps in one row (the kernel on the card, its plain walk here)
    if backend == "cuda":
        carry = torch.tensor(reference["inputs"][cid]).reshape(n, -1)
        run = tsk.run_segment(np.asarray([[0, 0, k]], np.int32), None, None,
                              carry, kind)
        np.testing.assert_allclose(run.w.numpy(), want, rtol=RTOL, atol=0)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("k", STEPS)
@pytest.mark.parametrize("case", NUMERIC, ids=[c[0] for c in NUMERIC])
def test_per_sample_collective_matches_reference(case, k, backend,
                                                 reference):
    cid, shape, axes, axis, kind = case
    atom = CollectiveAtom(make_mesh(shape, axes, "cpu"), axis=axis,
                          kind=kind, backend=backend)
    fn = atom._coll_fn()
    n = shape[axes.index(axis)]
    x = _shards(reference["inputs"][cid], shape, axes, axis)
    for _ in range(k):
        x = fn(x)
        if kind == "all-gather":       # the grown output feeds the next
            x = x.reshape(*x.shape[:-2], -1)
    want = reference["numeric"][(cid, k)][1].reshape(n, -1)
    for rep in _along_axis(x, axes, axis).unbind(0):
        np.testing.assert_allclose(rep.numpy(), want, rtol=RTOL, atol=0)


class _Grab:
    """A plan cache that builds nothing and returns the key it is asked
    for."""

    def get_or_build(self, key, builder):
        return key


@pytest.mark.parametrize("mesh", KEY_MESHES, ids=lambda m: str(m[0]))
def test_plan_keys_and_amounts_match_reference(mesh, reference):
    shape, axes, axis = mesh
    live = make_mesh(shape, axes, "cpu")
    for kind in KINDS:
        atom = CollectiveAtom(live, axis=axis, kind=kind)
        atom.cache = _Grab()
        n = shape[axes.index(axis)]
        for w in KEY_AMOUNTS:
            r_key, r_amount = reference["keys"][(shape, axis, kind, w)]
            got = atom.plan(w)
            if T.collective_factor(kind, n) == 0.0:
                # one shard moves nothing: the port plans a no-op where the
                # reference inverts its ring model through max(factor,
                # 1e-9) into an operand of 2.5e8 floats a wire byte
                assert isinstance(got, T.Plan) and got.amount == 0.0
                assert r_amount == 0.0
                assert r_key[-1] >= int(w / 4e-9) - 1
                continue
            assert got == r_key
            assert atom.quantized_wire_bytes(got[-1]) == r_amount


@pytest.mark.parametrize("mesh", TABLE_MESHES,
                         ids=lambda m: f"{m[0]}-{m[2]}")
def test_compiled_tables_match_reference(mesh, reference, tmp_path):
    shape, axes, kind = mesh
    em = _mesh_em(tmp_path, shape, axes, kind)
    for name, rvs in PROFILES.items():
        got = em.compile(_profile(T, rvs)).detach()
        want = reference["tables"][(shape, kind, name)]
        assert got.get("collective") == want.get("collective")
        assert len(got["steps"]) == len(want["steps"])
        for a, b in zip(got["steps"], want["steps"]):
            assert a["kind"] == b["kind"]
            if a["kind"] == "segment":
                np.testing.assert_array_equal(a["table"], b["table"])
                assert a["rows"] == b["rows"]
            else:
                assert (a["resources"], a["count"]) == \
                    (b["resources"], b["count"])
    if shape == (1,):
        # n == 1: the quantization folds every wire amount to no steps
        assert em.collective.quant().iters_for(1.52e10) == 0
        assert not em.compile(_profile(T, PROFILES["training"])).mesh_bound


def test_payloads_cross_both_ways(reference, tmp_path):
    em = _mesh_em(tmp_path)
    prof = _profile(T, PROFILES["wire_heavy"])
    # the reference's mesh-bound schedule replays here ...
    sched = T.rehydrate_schedule(reference["payload"])
    assert sched.mesh_bound
    rep = em.replay(sched, command="coll-test", planned=prof.totals)
    assert rep.consumed == prof.totals
    assert _dump(rep) == reference["payload_replay"]
    # ... and the port's replays there, with the same report
    assert reference["port_payload_replay"] == reference["payload_replay"]
    mine = em.compile(prof)
    for a, b in zip(mine.detach()["steps"], reference["payload"]["steps"]):
        if a["kind"] == "segment":
            np.testing.assert_array_equal(a["table"], b["table"])
    em.storage.cleanup()


# ---------------------------------------------------------------------------
# the port's own: meshes, the segment's wire leg, the 1-shard fold, predict
# ---------------------------------------------------------------------------

def test_mesh_names_its_shards_on_one_device():
    mesh = make_mesh((2, 4), ("data", "model"), "cpu")
    assert describe(mesh) == {"data": 2, "model": 4}
    assert mesh.shape == {"data": 2, "model": 4} and mesh.shared
    assert mesh.devices.shape == (2, 4) and mesh.size == 8
    assert set(mesh.devices.flat) == {torch.device("cpu")}
    assert mesh.shard_ids == tuple(range(8)) and mesh.dim("model") == 1
    for shape, axes in (((2,), ()), ((), ()), ((0,), ("x",)),
                        ((2, 2), ("x", "x"))):
        with pytest.raises(ValueError):
            make_mesh(shape, axes, "cpu")


@pytest.mark.parametrize("kind", KINDS)
def test_segment_wire_leg_is_the_loop_body(kind):
    """The segment's plain walk steps the carry as the loop body does, row
    by row after the burn and the ring, and counts nothing on the CPU."""
    rng = np.random.default_rng(3)
    w0 = torch.from_numpy(rng.standard_normal((2, 64)).astype(np.float32))
    table = np.asarray([[2, 0, 3], [0, 0, 0], [1, 0, 4]], np.int32)
    x = torch.eye(TILE) * 0.5
    before = (tsk.launches, tsk.wire_launches, tsk.steps)
    w = w0.clone()
    run = tsk.run_segment(table, x, None, w, kind)
    assert run.w is w and run.y.shape == (TILE, TILE)
    want = w0.clone()
    for _ in range(7):
        want = tcref.loop_step(want, dim=0, kind=kind)
    torch.testing.assert_close(w, want, rtol=0, atol=0)
    assert (tsk.launches, tsk.wire_launches, tsk.steps) == before
    with pytest.raises(ValueError, match="collective"):
        tsk.run_segment(table, x, None, None, kind)
    with pytest.raises(ValueError, match="collective"):
        tsk.run_segment(table, x, None, w, "broadcast")


def test_collective_wrapper_rejects_what_the_kernel_does_not_take():
    x = torch.ones(2, 8)
    for bad, dim, kind in ((x, 0, "broadcast"), (x.double(), 0, "all-reduce"),
                           (torch.ones(8), 0, "all-reduce"),
                           (x, 1, "all-reduce"), (x.t(), 0, "all-reduce")):
        with pytest.raises((TypeError, ValueError)):
            tck.collective(bad, dim=dim, kind=kind)


def test_predict_wire_only_profile_on_h100():
    wire = 1.52e10
    prof = _profile(T, [{"ici": wire}, {"ici": wire / 2}])
    pred = T.predict(prof, T.H100_SXM)
    assert T.H100_SXM.ici_bw == 450e9
    assert pred.terms.collective_s == wire * 1.5 / 450e9
    assert pred.ttc_max == wire / 450e9 + wire / 2 / 450e9
    assert pred.terms.dominant == "collective"
    assert CollectiveAtom().seconds(wire, T.H100_SXM) == wire / 450e9
    assert T.H100_SXM.name not in REGISTRY


def test_emulator_mesh_on_another_device_raises():
    with pytest.raises(ValueError, match="emulator's device"):
        _em(T, mesh=make_mesh((2,), ("model",), "meta"))
    em = _em(T)
    with pytest.raises(ValueError, match="emulator's device"):
        em.attach_collective(CollectiveAtom(make_mesh((2,), ("model",),
                                                      "meta")))
    assert em.collective is None
    spec = _mesh_em().spec()
    assert spec.collective == T.CollectiveSpec(axis="model")
    twin = spec.build(mesh=make_mesh((2,), ("model",), "cpu"), device="cpu")
    assert twin.collective.quant() == T.CollectiveQuant(n=2)
    assert twin.collective.backend == twin.compute.backend


# ---------------------------------------------------------------------------
# the parity cases of tests/test_fleet.py and tests/test_dag.py
# ---------------------------------------------------------------------------

def test_keep_collectives_lowers_wire_runs_to_barriers():
    rvs = [{"flops": FPI}, {"flops": FPI, "ici": 4e6}, {"hbm": BPI}]
    for pkg, barrier in ((T, BarrierStep), (R, RBarrierStep)):
        em = _em(pkg)
        prof = _profile(pkg, rvs)
        folded = em.compile(prof)
        assert [type(s).__name__ for s in folded.steps] == ["FusedSegment"]
        kept = em.compile(prof, keep_collectives=True)
        assert [type(s).__name__ for s in kept.steps] == \
            ["FusedSegment", "BarrierStep", "FusedSegment"]
        assert isinstance(kept.steps[1], barrier)
        assert em.replay(folded, command="f").consumed == \
            em.replay(kept, command="k").consumed == prof.totals
    # and on a mesh the kept barrier executes its wire leg per sample
    em = _mesh_em()
    rep = em.replay(em.compile(_profile(T, rvs), keep_collectives=True),
                    command="k")
    assert rep.n_collective_dispatches == 1 and rep.emulated_ici_bytes == 4e6


def test_mesh_spec_validates_and_counts_devices():
    for pkg in (TF, RF):
        assert pkg.MeshSpec(shape=(2, 4),
                            axes=("data", "model")).device_count == 8
        with pytest.raises(ValueError):
            pkg.MeshSpec(shape=(2, 4), axes=("model",))
        with pytest.raises(ValueError):
            pkg.MeshSpec(shape=(), axes=())
    em = _em(T)
    with pytest.raises(ValueError, match="process"):
        em.emulate_many([_profile(T, [{"flops": FPI}])], executor="thread",
                        mesh_spec=TF.MeshSpec(shape=(2,), axes=("model",)))


def test_trace_links_collective_legs_across_workers():
    traces = {}
    for rec_cls, chrome in ((FlightRecorder, to_chrome_trace),
                            (RFlightRecorder, r_chrome_trace)):
        rec = rec_cls("coordinator")
        rec.record("collective_leg", t=1.0, scope="worker:0", idx=0, n=2,
                   group="allreduce:7")
        rec.record("collective_leg", t=2.0, scope="worker:1", idx=1, n=2,
                   group="allreduce:7")
        rec.record("collective_leg", t=3.0, scope="worker:0", idx=2, n=1)
        trace = chrome(rec.events())
        links = [e for e in trace["traceEvents"]
                 if e.get("name") == "collective_link"]
        assert len(links) == 2
        assert {e["ph"] for e in links} == {"s", "f"}
        assert links[0]["id"] == links[1]["id"]
        traces[rec_cls] = trace
    validate_trace(traces[FlightRecorder])
    assert traces[FlightRecorder] == traces[RFlightRecorder]


# ---------------------------------------------------------------------------
# fleets: process and remote workers build their own meshes (spawns)
# ---------------------------------------------------------------------------

@pytest.fixture
def one_thread(monkeypatch):
    """Spawned CPU workers run torch on one intra-op thread."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _fleet_jobs():
    return [_profile(T, [{"flops": FPI, "ici": 4e6}, {"flops": 2 * FPI},
                         {"ici": 2e6}, {"hbm": BPI}], "coll-a"),
            _profile(T, PROFILES["wire_heavy"], "coll-b"),
            TS.generate("training_scan", n_steps=4, ckpt_every=2,
                        flops_per_step=4e7, hbm_per_step=2e6,
                        ici_per_step=4e6, ckpt_bytes=2 << 20)]


@pytest.mark.parametrize("chaos", [None, "kill"])
def test_process_fleet_replays_mesh_bound_segments(chaos, one_thread,
                                                   tmp_path):
    """A meshless parent ships mesh-bound bundles; process workers build
    their own 2-shard mesh on the CPU and replay them bit for bit like the
    in-process replay on the same mesh, with and without a worker
    killed."""
    mesh_spec = TF.MeshSpec(shape=(2,), axes=("model",))
    parent = _em(T, tmp_path)
    local = _mesh_em(tmp_path)
    jobs = _fleet_jobs()
    refs = [local.replay(parent.compile(p, mesh_spec=mesh_spec),
                         command=p.command, planned=p.totals) for p in jobs]
    local.storage.cleanup()
    policy = TF.ChaosPolicy(seed=1, kill_every=2, max_faults=1) \
        if chaos else None
    fleet = parent.emulate_many(jobs, config=TF.FleetConfig.process(
        max_workers=2, mesh=mesh_spec, chaos=policy, timeout=300.0))
    for ref, rep in zip(refs, fleet.reports):
        assert rep.mode == "fused"
        assert _dump(rep) == _dump(ref)
    want = T.ResourceVector()
    for p in jobs:
        want = want.add(p.totals)
    assert fleet.totals == want
    assert fleet.reports[0].n_dispatches == 1
    assert fleet.reports[0].n_collective_dispatches == 2
    assert fleet.reports[2].n_collective_dispatches > 0
    if chaos:
        assert fleet.recovery["worker_deaths"] >= 1


def test_process_fleet_bit_identical_and_collectives_execute(one_thread,
                                                             tmp_path):
    """tests/test_fleet.py's acceptance contract: a mixed job set replayed
    by a warm process pool whose workers own 2-shard meshes consumes what
    the reference's in-process replay consumes, and the wire profile
    issues collective dispatches on the workers' meshes; the ready info
    names the mesh."""
    r_em, t_em = _em(R, tmp_path), _em(T, tmp_path)
    profiles = {pkg: [S.generate("mixed_fleet", total_samples=6, seed=1),
                      S.generate("training_scan", n_steps=4, ckpt_every=2,
                                 flops_per_step=4e7, hbm_per_step=2e6,
                                 ckpt_bytes=2 << 20),
                      _profile(core, [{"flops": FPI, "ici": 4e6},
                                      {"hbm": BPI}], "coll")]
                for pkg, S, core in (("torch", TS, T), ("jax", RS, R))}
    refs = [r_em.emulate(p, fused=True) for p in profiles["jax"]]
    r_em.storage.cleanup()
    mesh_spec = TF.MeshSpec(shape=(2,), axes=("model",))
    spec = TF.FleetConfig.process(max_workers=2, mesh=mesh_spec).worker_spec(
        t_em.spec(), device="cpu")
    with TF.ProcessFleet(2, spec) as pool:
        infos = pool.warmup(timeout=120.0)
        fleet = TF.run_process_fleet(t_em, profiles["torch"], fleet=pool,
                                     mesh_spec=mesh_spec)
    assert [i["mesh"] for i in infos] == [
        {"shape": [2], "axes": ["model"], "shared": True}] * 2
    assert fleet.cache_stats["worker_deaths"] == 0
    for ref, rep in zip(refs, fleet.reports):
        assert rep.mode == "fused"
        assert rep.consumed.to_dict() == ref.consumed.to_dict()
        assert rep.n_samples == ref.n_samples
    coll = fleet.reports[-1]
    assert coll.consumed.ici_total == 4e6
    assert coll.n_collective_dispatches > 0
    assert coll.summary()["ici_bytes"] == 4e6


@pytest.mark.parametrize("chaos", [None, "kill"])
def test_remote_fleet_replays_mesh_bound_segments(chaos, one_thread,
                                                  tmp_path):
    """The same mesh-bound bundles over loopback framed TCP: one local
    agent's 2 workers build their meshes and fuse the collectives too,
    also when a worker is killed and its bundle requeued."""
    old = os.environ.get("PYTHONPATH", "")
    env = dict(os.environ, PYTHONPATH=SRC + (os.pathsep + old if old else ""))
    parent = _em(T, tmp_path)
    local = _mesh_em(tmp_path)
    mesh_spec = TF.MeshSpec(shape=(2,), axes=("model",))
    prof = _profile(T, [{"flops": FPI, "ici": 4e6}, {"ici": 2e6},
                        {"hbm": BPI}], "coll-test:remote")
    ref = local.replay(parent.compile(prof, mesh_spec=mesh_spec),
                       command=prof.command, planned=prof.totals)
    policy = TF.ChaosPolicy(seed=1, kill_every=2, max_faults=1) \
        if chaos else None
    fleet = TF.RemoteFleet(TF.WorkerSpec(emulator=parent.spec(),
                                         mesh=mesh_spec, device="cpu",
                                         chaos=policy),
                           listen="127.0.0.1:0", agents=1)
    agent = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.fleet.agent", "--connect",
         f"127.0.0.1:{fleet.bound_addr[1]}", "--workers", "2"], env=env)
    try:
        bundles = [TF.bundle_profile(parent, prof, mesh_spec=mesh_spec)
                   for _ in range(3)]
        reports = fleet.run(bundles, timeout=180.0)
        requeued = fleet.last_recovery["requeued"]
    finally:
        fleet.close()
        try:
            agent.wait(timeout=30.0)
        except subprocess.TimeoutExpired:
            agent.kill()
            agent.wait(timeout=10.0)
    assert len(reports) == 3
    for rep in reports:
        assert rep.mode == "fused"
        assert rep.consumed == ref.consumed == prof.totals
        assert rep.n_dispatches == 1
        assert rep.n_collective_dispatches == 2
        assert _dump(rep) == _dump(ref)
    assert (requeued >= 1) == bool(chaos)

"""The slice as a whole: the port's emulator against the JAX package's.

Mirrors ``tests/test_schedule.py``'s profiles (alternating, interleaved
storage, scales and speed, collapse, sub-minimum, empty).  The port's fused
``"torch"`` and per-sample runs must equal the reference's ``"jnp"`` runs,
and the port's ``"cuda"`` kernel backend (its plain versions, on the CPU)
must equal the reference's ``"pallas"`` backend where that backend can run:
consumed totals, sample counts, mode and dispatches, bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.core as R
import repro_torch.core as T
from repro.kernels.compute_atom import ref as cref
from repro_torch.kernels.compute_atom import kernel as tck

TILE = 64
BLOCK = 1 << 18
FPI = 2.0 * TILE ** 3
BPI = 2.0 * BLOCK


def _em(pkg, tmp_path=None, **kw):
    extra = {"device": "cpu"} if pkg is T else {}
    em = pkg.Emulator(calib=pkg.HostCalibration(1e9, 1e9, 1e8, 1e8),
                      compute_tile=TILE, mem_block=BLOCK, **extra, **kw)
    if tmp_path is not None:
        em.storage.dir = str(tmp_path)
    return em


def _rv(pkg, flops=0.0, hbm=0.0, sw=0.0, sr=0.0, ici=0.0):
    return pkg.ResourceVector(flops=flops, hbm_bytes=hbm,
                              storage_write_bytes=sw, storage_read_bytes=sr,
                              ici_bytes={"all-reduce": ici} if ici else {})


def _profile(pkg, rvs):
    return pkg.SynapseProfile(command="emu-parity", samples=[
        pkg.Sample(index=i, resources=_rv(pkg, **r))
        for i, r in enumerate(rvs)])


PROFILES = {
    "alternating": [{"flops": (1 + i % 2) * FPI, "hbm": (1 + i % 2) * BPI}
                    for i in range(32)],
    "interleaved_storage": [
        {"flops": 2 * FPI, "hbm": BPI}, {"flops": 2 * FPI, "hbm": BPI},
        {"flops": FPI, "hbm": 2 * BPI},
        {"flops": FPI, "sw": 2 << 20, "sr": 1 << 20},
        {"flops": 2 * FPI, "hbm": BPI}, {"flops": 3 * FPI},
        {"sr": 1 << 20}, {"hbm": 2 * BPI}],
    "collapse": [{"flops": FPI, "hbm": BPI}] * 16,
    "subminimum": [{"flops": FPI * 0.2, "hbm": BPI * 0.2}, {"flops": FPI}],
    "all_noop": [{"flops": FPI * 0.2}, {"hbm": BPI * 0.2}],
    "empty": [],
    "wire_folded": [{"flops": FPI, "ici": 3e5}, {"hbm": BPI, "ici": 1e6},
                    {"flops": 2.6 * FPI, "hbm": 1.4 * BPI}],
    "compute_only": [{"flops": (1 + i % 3) * FPI * 1.3} for i in range(8)],
}
COMPUTE_ONLY = ["compute_only", "subminimum", "all_noop", "empty"]


def _same(t_rep, r_rep):
    assert t_rep.consumed.to_dict() == r_rep.consumed.to_dict()
    assert t_rep.planned is None or \
        t_rep.planned.to_dict() == r_rep.planned.to_dict()
    for f in ("n_samples", "mode", "n_dispatches", "n_collective_dispatches",
              "emulated_ici_bytes", "command"):
        assert getattr(t_rep, f) == getattr(r_rep, f), f
    assert len(t_rep.per_sample_s) == len(r_rep.per_sample_s)


def _both(name, tmp_path, r_kw=None, t_kw=None, **emulate_kw):
    r_em = _em(R, tmp_path, **(r_kw or {}))
    t_em = _em(T, tmp_path, **(t_kw or {}))
    try:
        r_rep = r_em.emulate(_profile(R, PROFILES[name]), **emulate_kw)
        t_rep = t_em.emulate(_profile(T, PROFILES[name]), **emulate_kw)
    finally:
        r_em.storage.cleanup()
        t_em.storage.cleanup()
    return t_rep, r_rep


@pytest.mark.parametrize("name", sorted(PROFILES))
@pytest.mark.parametrize("fused", [True, False])
def test_torch_backend_matches_jnp(name, fused, tmp_path):
    t_rep, r_rep = _both(name, tmp_path, fused=fused)
    _same(t_rep, r_rep)
    assert t_rep.consumed.to_dict() == \
        _profile(T, PROFILES[name]).totals.to_dict()


@pytest.mark.parametrize("fused", [True, False])
def test_scales_and_speed_match(fused, tmp_path):
    t_rep, r_rep = _both("alternating", tmp_path, r_kw={"speed": 2.0},
                         t_kw={"speed": 2.0}, fused=fused, flops_scale=3.0,
                         mem_scale=0.5)
    _same(t_rep, r_rep)


def test_fused_dispatch_counts_pinned(tmp_path):
    """The shape tests/test_schedule.py pins for the reference."""
    t_fused, _ = _both("alternating", tmp_path, fused=True)
    t_legacy, _ = _both("alternating", tmp_path, fused=False)
    assert (t_fused.n_dispatches, t_legacy.n_dispatches) == (1, 64)
    t_em = _em(T, tmp_path)
    kinds = [type(s).__name__ for s in
             t_em.compile(_profile(T, PROFILES["interleaved_storage"])).steps]
    assert kinds == ["FusedSegment", "BarrierStep", "FusedSegment",
                     "BarrierStep", "FusedSegment"]


@pytest.mark.parametrize("name", COMPUTE_ONLY)
def test_cuda_backend_matches_pallas_compute_only(name, tmp_path):
    """Per sample, the reference's pallas backend's only path (the port's
    fused ``"cuda"`` replay is held to ``"jnp"`` in test_torch_segment)."""
    tck.launches = 0
    t_rep, r_rep = _both(name, tmp_path, r_kw={"backend": "pallas"},
                         t_kw={"backend": "cuda"}, fused=False)
    _same(t_rep, r_rep)
    assert t_rep.mode == "per_sample"
    assert tck.launches == 0                  # CPU tensors: plain version


@pytest.mark.parametrize("name", sorted(set(PROFILES) - set(COMPUTE_ONLY)))
def test_cuda_backend_with_memory_legs_matches_jnp_per_sample(name,
                                                              tmp_path):
    """The reference's pallas memory leg cannot run (see below), so the
    oracle is its jnp backend replayed per sample: the same plans."""
    t_rep, r_rep = _both(name, tmp_path, t_kw={"backend": "cuda"},
                         fused=False)
    _same(t_rep, r_rep)
    assert t_rep.mode == "per_sample"


def test_reference_pallas_memory_leg_raises():
    """Pinned reference fault: repro/kernels/memory_atom/ops.py:9-14 jits
    ``stream`` with ``block_bytes`` missing from ``static_argnames``, so
    ``if block_bytes:`` fails while tracing.  The port's ``"cuda"`` memory
    atom runs the same profile."""
    prof = [{"hbm": 2 * BPI}]
    with pytest.raises(jax.errors.TracerBoolConversionError):
        _em(R, backend="pallas").emulate(_profile(R, prof))
    rep = _em(T, backend="cuda").emulate(_profile(T, prof))
    assert rep.n_dispatches == 1 and rep.consumed.hbm_bytes == 2 * BPI


def test_cuda_burn_runs_planned_iters_unlike_reference():
    """Pinned reference quirk: repro/core/atoms.py:326-328 runs the pallas
    burn with ``iters=1`` whatever was planned, yet the plan reports
    ``iters * flops_per_iter``.  The port's ``"cuda"`` atom burns the
    planned iterations; amounts and dispatches stay the reference's."""
    iters = 5
    r_atom = R.ComputeAtom(tile=TILE, backend="pallas")
    t_atom = T.ComputeAtom(tile=TILE, backend="cuda", device="cpu")
    r_plan, t_plan = r_atom.plan(iters * FPI), t_atom.plan(iters * FPI)
    assert t_plan.amount == r_plan.amount == iters * FPI
    x0 = jnp.eye(TILE, dtype=jnp.float32) * 0.5
    one = np.asarray(cref.burn_tile(x0, iters=1))
    planned = np.asarray(cref.burn_tile(x0, iters=iters))
    assert not np.allclose(one, planned)
    np.testing.assert_allclose(np.asarray(r_plan.launch()), one, atol=1e-6)
    np.testing.assert_allclose(t_plan.launch().numpy(), planned, atol=1e-6)
    assert t_plan() == r_plan() == iters * FPI


def test_cuda_memory_atom_streams_planned_passes():
    iters = 3
    t_plan = T.MemoryAtom(block_bytes=BLOCK, backend="cuda",
                          device="cpu").plan(iters * BPI)
    assert t_plan.amount == iters * BPI
    out = t_plan.launch()
    want = np.ones(BLOCK // 4, np.float32)
    for _ in range(iters):
        want = want * np.float32(1.0000001)
    np.testing.assert_array_equal(out.numpy(), want)


def _ring_values(slots, passes):
    """Slot values of a ring of ones after ``passes`` in-place passes:
    pass p scales slot p % slots once, in float32."""
    want = np.ones(slots, np.float32)
    for p in range(passes):
        want[p % slots] *= np.float32(1.0000001)
    return want


def test_torch_memory_atom_streams_its_ring_in_place():
    """The ``"torch"`` memory leg passes over the atom's ring in place (the
    ``"cuda"`` ring's plain version), one slot on the CPU: its plan keys
    and amounts are the reference's, its values the chained stream's."""
    iters = 3
    atom = T.MemoryAtom(block_bytes=BLOCK, backend="torch", device="cpu")
    ref_atom = R.MemoryAtom(block_bytes=BLOCK)
    plan = atom.plan(iters * BPI)
    assert plan.amount == ref_atom.plan(iters * BPI).amount == iters * BPI
    ring = atom.ring()
    assert ring.slots == 1 and ring.passes == 0
    out = plan.launch()
    assert out.data_ptr() == ring.data.data_ptr()       # in place
    assert ring.passes == iters
    np.testing.assert_array_equal(out.numpy(), np.full(
        BLOCK // 4, _ring_values(1, iters)[0]))
    plan.launch()
    assert ring.passes == 2 * iters


def test_torch_stream_numbers_passes_over_a_ring_of_slots():
    """On a card the ring has several slots: pass p streams slot
    p % slots, numbered on across the atom's plans and the fused loop."""
    from repro_torch.core.atoms import memory_stream_body
    from repro_torch.kernels.memory_atom.kernel import Ring
    ring = Ring(BLOCK, "cpu", slots=3)
    for p in range(4):
        assert memory_stream_body(ring, p).data_ptr() == \
            ring.data[p % 3].data_ptr()
    ring = Ring(BLOCK, "cpu", slots=3)
    atom = T.MemoryAtom(block_bytes=BLOCK, backend="torch", device="cpu")
    atom._ring = ring
    atom.plan(3 * BPI).launch()                          # passes 0, 1, 2
    runner = T.SegmentRunner(tile=TILE, block_bytes=BLOCK, device="cpu",
                             ring=atom.ring)
    run = runner.launch(T.FusedSegment(table=[[0, 2, 0], [1, 0, 0],
                                              [0, 5, 0]]))   # 3 .. 9
    assert ring.passes == 10
    assert run.slot.data_ptr() == ring.data[9 % 3].data_ptr()
    np.testing.assert_array_equal(ring.data[:, 0].numpy(),
                                  _ring_values(3, 10))


@pytest.mark.parametrize("table", [
    [[3, 0, 0], [1, 0, 0], [0, 0, 0]],          # compute-only segment
    [[0, 2, 0], [0, 5, 0]],                      # memory-only segment
    [[2, 1, 0], [0, 3, 0], [4, 0, 0]],           # both carries
])
def test_segment_carry_matches_reference(table):
    seg_r = R.FusedSegment(table=np.asarray(table, np.int32))
    seg_t = T.FusedSegment(table=np.asarray(table, np.int32))
    want = R.SegmentRunner(tile=TILE, block_bytes=BLOCK).launch(seg_r)
    run = T.SegmentRunner(tile=TILE, block_bytes=BLOCK,
                          device="cpu").launch(seg_t)
    got = [c for c in (run.y, run.slot) if c is not None]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=0)


def test_segment_runner_noop_and_run():
    runner = T.SegmentRunner(tile=TILE, block_bytes=BLOCK, device="cpu")
    assert runner.launch(T.FusedSegment(table=[[0, 0, 0]])) is None
    assert runner.run(T.FusedSegment(table=[[0, 0, 0]])) is False
    assert runner.run(T.FusedSegment(table=[[1, 1, 0]])) is True


def test_replayed_reference_schedule_matches(tmp_path):
    """A schedule compiled by the reference replays here with the
    reference's accounting (the ship-a-payload path)."""
    r_em, t_em = _em(R, tmp_path), _em(T, tmp_path)
    try:
        prof = PROFILES["interleaved_storage"]
        r_sched = r_em.compile(_profile(R, prof))
        r_rep = r_em.replay(r_sched, command="emu-parity")
        t_rep = t_em.replay(T.rehydrate_schedule(r_sched.detach()),
                            command="emu-parity")
    finally:
        r_em.storage.cleanup()
        t_em.storage.cleanup()
    _same(t_rep, r_rep)


def test_mesh_and_mesh_bound_schedules_raise(tmp_path):
    """What must still raise now that meshes run: a mesh whose shards lie
    on another device than its emulator's, a meshless replay or launch of
    a mesh-bound schedule, and a schedule quantized for another mesh; the
    same schedule replays on an emulator with the mesh it was quantized
    for."""
    from collections import namedtuple
    from repro_torch.launch.mesh import make_mesh
    with pytest.raises(ValueError, match="emulator's device"):
        T.Emulator(calib=T.HostCalibration(1, 1, 1, 1),
                   mesh=make_mesh((2,), ("x",), "meta"), device="cpu")
    em = _em(T, tmp_path)
    ms = namedtuple("MeshSpec", "shape axes")((2,), ("x",))
    sched = em.compile(_profile(T, PROFILES["wire_folded"]), mesh_spec=ms)
    assert sched.mesh_bound
    with pytest.raises(RuntimeError, match="no mesh"):
        em.replay(sched)
    with pytest.raises(RuntimeError, match="mesh-bound"):
        em._segments.launch(sched.segments[0])
    skewed = namedtuple("MeshSpec", "shape axes")((4,), ("x",))
    meshed = _em(T, tmp_path, mesh=make_mesh((2,), ("x",), "cpu"))
    with pytest.raises(RuntimeError, match="quantized for"):
        meshed.replay(meshed.compile(_profile(T, PROFILES["wire_folded"]),
                                     mesh_spec=skewed))
    rep = meshed.replay(sched)
    assert rep.n_collective_dispatches > 0 and rep.emulated_ici_bytes > 0


def test_spec_rebuilds_an_equivalent_emulator(tmp_path):
    import pickle
    em = _em(T, tmp_path, backend="cuda", efficiency=0.5, speed=2.0)
    spec = pickle.loads(pickle.dumps(em.spec()))
    twin = spec.build(device="cpu")
    assert twin.spec() == em.spec()
    assert (twin.compute.backend, twin.compute.tile, twin.memory.block_bytes,
            twin.speed, twin._fusable) == ("cuda", TILE, BLOCK, 2.0, True)
    prof = _profile(T, PROFILES["alternating"])
    assert twin.compile(prof).detach()["steps"][0]["table"].tolist() == \
        em.compile(prof).detach()["steps"][0]["table"].tolist()


def test_plan_cache_shares_plans_like_reference(tmp_path):
    r_cache, t_cache = R.PlanCache(), T.PlanCache()
    for _ in range(2):
        _em(R, tmp_path, plan_cache=r_cache).emulate(
            _profile(R, PROFILES["alternating"]), fused=False)
        _em(T, tmp_path, plan_cache=t_cache).emulate(
            _profile(T, PROFILES["alternating"]), fused=False)
    assert t_cache.stats() == r_cache.stats()


def test_emulator_report_planned_is_profile_totals(tmp_path):
    em = _em(T, tmp_path)
    prof = _profile(T, PROFILES["alternating"])
    rep = em.emulate(prof)
    assert rep.planned == prof.totals

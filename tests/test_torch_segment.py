"""The fused segment loop of the ``"cuda"`` backend against the JAX package.

On the CPU the segment kernel's wrapper runs its plain version, the table
walked on the host: its burn carry is held to the JAX package's Pallas
``burn_tile`` (interpret mode) at 1e-5, and its ring, with one slot (as on
the CPU), to the JAX package's chained ``stream`` bit for bit.  The
``"cuda"`` emulator's fused replay must equal the reference's ``"jnp"``
fused replay in every amount it reports, in process and in a worker
process.  ``tests/test_torch_cuda.py`` holds the kernel itself to the
plain version on a card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
import repro_torch.fleet as TF
import repro_torch.scenarios as TS
from repro.kernels.compute_atom import kernel as rck
from repro.kernels.memory_atom import ops as rmops
from repro_torch.kernels.memory_atom import kernel as tmk
from repro_torch.kernels.memory_atom import ref as tmref
from repro_torch.kernels.segment import kernel as tsk
from repro_torch.kernels.segment import ops as tsops
from repro_torch.kernels.segment import ref as tsref
from test_torch_emulator import PROFILES, _profile

TILE = 64
BLOCK = 1 << 18
N = 4096                   # ring block of the plain-version checks

# the tables of tests/test_torch_emulator.py's carry test, then one whose
# zero rows sit between and after the rows with work
TABLES = [
    [[3, 0, 0], [1, 0, 0], [0, 0, 0]],           # compute-only segment
    [[0, 2, 0], [0, 5, 0]],                      # memory-only segment
    [[2, 1, 0], [0, 3, 0], [4, 0, 0]],           # both carries
    [[0, 0, 0], [5, 2, 0], [0, 0, 0], [1, 0, 0], [0, 0, 0]],
]


def _rng_array(shape, seed):
    return (np.random.default_rng(seed).standard_normal(shape)
            * 0.1).astype(np.float32)


def _cuda_em(pkg=T, **kw):
    extra = {"device": "cpu"} if pkg is T else {}
    return pkg.Emulator(calib=pkg.HostCalibration(1e9, 1e9, 1e8, 1e8),
                        compute_tile=TILE, mem_block=BLOCK, **extra, **kw)


@pytest.mark.parametrize("table", TABLES)
def test_segment_plain_version_matches_jax_burn_and_stream(table):
    t = np.asarray(table, np.int32)
    ci, mi = int(t[:, 0].sum()), int(t[:, 1].sum())
    x, block = _rng_array((TILE, TILE), 0), _rng_array((N,), 1)
    ring = torch.from_numpy(block.copy()).reshape(1, N)
    y = tsref.run_segment(t, torch.from_numpy(x), ring, start=0)
    want_y = np.asarray(rck.burn_tile(jnp.asarray(x), iters=ci,
                                      interpret=True))
    if ci:
        np.testing.assert_allclose(y.numpy(), want_y, atol=1e-5, rtol=1e-5)
    else:
        assert y is None
    want_m = np.asarray(rmops.stream(jnp.asarray(block), iters=mi,
                                     block=1024))
    np.testing.assert_array_equal(ring[0].numpy(), want_m)


@pytest.mark.parametrize("table", TABLES)
def test_segment_wrapper_on_cpu_runs_the_plain_version(table):
    """CPU tensors: the plain version, no launch and no device count; the
    ring's pass counter runs on across segments."""
    t = np.asarray(table, np.int32)
    ci, mi = int(t[:, 0].sum()), int(t[:, 1].sum())
    x = torch.from_numpy(_rng_array((TILE, TILE), 2))
    ring = tmk.Ring(4 * N, "cpu", slots=3)
    before = (tsk.launches, tsk.iterations, tsk.passes)
    runs = [tsops.segment(t, x=x, ring=ring) for _ in range(2)]
    for run in runs:
        run.settle()
    assert (tsk.launches, tsk.iterations, tsk.passes) == before
    assert ring.passes == 2 * mi
    want = torch.ones(3, N)
    tmref.ring_pass(want, start=0, passes=2 * mi)
    assert torch.equal(ring.data, want)
    if ci:
        torch.testing.assert_close(runs[1].y, tsref.run_segment(
            t, x, torch.ones(1, N)), atol=0, rtol=0)
    else:
        assert runs[1].y is None
    if mi:
        assert runs[1].slot.data_ptr() == \
            ring.data[(2 * mi - 1) % 3].data_ptr()
    else:
        assert runs[1].slot is None


@pytest.mark.parametrize("passes", [1, 5, 17])
def test_ring_of_one_slot_is_the_reference_chained_stream(passes):
    """One slot, as the ring has on the CPU: its passes are the JAX
    package's chained ``stream``, bit for bit in float32."""
    x = _rng_array((2048,), 3)
    ring = tmk.Ring(2048 * 4, "cpu")
    assert ring.slots == 1
    ring.data.copy_(torch.from_numpy(x))
    before = (tmk.ring_launches, tmk.ring_passes)
    last = tmk.stream_ring(ring, passes=passes)
    assert (tmk.ring_launches, tmk.ring_passes) == before
    want = np.asarray(rmops.stream(jnp.asarray(x), iters=passes, block=256))
    np.testing.assert_array_equal(ring.data[0].numpy(), want)
    assert last.data_ptr() == ring.data[0].data_ptr()


def test_ring_numbers_its_passes_across_calls():
    """Pass p streams slot p % slots, numbered on from the ring's counter:
    after 7 passes over 3 slots they have seen 3, 2 and 2."""
    ring = tmk.Ring(4 * 64, "cpu", slots=3)
    tmk.stream_ring(ring, passes=4)
    tmk.stream_ring(ring, passes=3)
    s = torch.tensor(1.0000001, dtype=torch.float32)
    ones = torch.ones(64)
    for slot, n in enumerate((3, 2, 2)):
        want = ones.clone()
        for _ in range(n):
            want = want * s
        assert torch.equal(ring.data[slot], want)


@pytest.mark.parametrize("bad,match", [
    (np.asarray([[1, -1, 0]], np.int32), "negative"),
    (np.asarray([[1, 1, 2]], np.int32), "collective"),
    (np.zeros((0, 3), np.int32), "non-empty"),
    (np.asarray([[1.0, 0.0, 0.0]]), "int32"),
])
def test_segment_wrapper_rejects_bad_tables(bad, match):
    x = torch.eye(TILE)
    with pytest.raises(ValueError, match=match):
        tsk.run_segment(bad, x, None)


def test_segment_wrapper_takes_only_the_cluster_tiles():
    """Tiles 64, 128 and 256 only, on the CPU as on the card: a "cuda"
    runner at another tile raises and never walks the table with torch
    ops."""
    t = np.asarray([[1, 0, 0]], np.int32)
    for tile in tsk.TILES:
        assert tsops.segment(t, x=torch.eye(tile)).y.shape == (tile, tile)
    for tile in (32, 320):
        with pytest.raises(ValueError, match="tile"):
            tsops.segment(t, x=torch.eye(tile))
    runner = T.SegmentRunner(tile=320, block_bytes=BLOCK, device="cpu",
                             backend="cuda")
    with pytest.raises(ValueError, match="tile"):
        runner.run(T.FusedSegment(table=[[2, 0, 0]]))


# the wire carry's share of a CTA's shared memory on the H100's grid of
# 132 CTAs (33,792 threads): the (n, 32768) carry of a fused segment is
# one column a thread, n x 1 KB a CTA; on a grid of 64 CTAs two columns
@pytest.mark.parametrize("n,grid,share", [(2, 132, 2048), (4, 132, 4096),
                                          (8, 132, 8192), (2, 64, 4096)])
def test_wire_share_of_shared_memory(n, grid, share):
    assert tsk.wire_share_bytes(n, 1 << 15, grid) == share
    assert tsk.check_wire_fits(256, n, 1 << 15, grid) == 9280 + share


# the burn's shared memory at each tile (two copies of a 4-row panel whose
# rows are padded by an eighth, and 8 mbarriers), and the most shards whose
# share fits beside it within an H100's 232,448 bytes a CTA
@pytest.mark.parametrize("tile,burn,most", [(64, 2368, 224),
                                            (128, 4672, 222),
                                            (256, 9280, 217)])
def test_wire_carry_limit_beside_the_burn(tile, burn, most):
    assert tsk.burn_smem_bytes(tile) == burn
    assert tsk.max_wire_shards(tile, 1 << 15, 132) == most
    assert tsk.check_wire_fits(tile, most, 1 << 15, 132) <= 232448
    with pytest.raises(ValueError, match=f"{most + 1} shards .* beyond the "
                       f"limit of 232448 bytes: at most {most} shards"):
        tsk.check_wire_fits(tile, most + 1, 1 << 15, 132)


@pytest.mark.parametrize("name", sorted(PROFILES))
def test_cuda_fused_report_equals_reference_jnp_fused(name, tmp_path):
    r_em, t_em = _cuda_em(R), _cuda_em(T, backend="cuda")
    r_em.storage.dir = t_em.storage.dir = str(tmp_path)
    try:
        r_sched = r_em.compile(_profile(R, PROFILES[name]))
        t_sched = t_em.compile(_profile(T, PROFILES[name]))
        r_rep = r_em.emulate(_profile(R, PROFILES[name]), fused=True)
        t_rep = t_em.emulate(_profile(T, PROFILES[name]), fused=True)
    finally:
        r_em.storage.cleanup()
        t_em.storage.cleanup()
    assert t_em._fusable
    assert t_rep.consumed.to_dict() == r_rep.consumed.to_dict()
    assert t_rep.planned.to_dict() == r_rep.planned.to_dict()
    for f in ("n_samples", "mode", "n_dispatches"):
        assert getattr(t_rep, f) == getattr(r_rep, f), f
    assert t_rep.mode == "fused"
    t_pay, r_pay = t_sched.detach(), r_sched.detach()
    assert [(s["kind"], np.asarray(s.get("table", [])).tolist(),
             s.get("rows"), s.get("resources"), s.get("count"))
            for s in t_pay["steps"]] == \
        [(s["kind"], np.asarray(s.get("table", [])).tolist(),
          s.get("rows"), s.get("resources"), s.get("count"))
         for s in r_pay["steps"]]


def test_cuda_fused_replay_counts_no_launch_on_the_cpu():
    em = _cuda_em(backend="cuda")
    before = (tsk.launches, tmk.ring_launches)
    rep = em.emulate(_profile(T, PROFILES["alternating"]))
    assert (rep.mode, rep.n_dispatches) == ("fused", 1)
    assert (tsk.launches, tmk.ring_launches) == before
    # one ring an emulator: its segments stream the memory atom's
    assert em._segments._ring() is em.memory.ring()
    assert em.memory.ring().passes == sum(
        s.memory_iters for s in em.compile(
            _profile(T, PROFILES["alternating"])).segments)


@pytest.fixture
def one_thread(monkeypatch):
    """Spawned CPU workers run torch on one intra-op thread each."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def test_one_worker_process_fleet_on_cuda_equals_in_process(tmp_path,
                                                            one_thread):
    """A worker given the ``"cuda"`` backend replays fused through the
    segment kernel's wrapper (its plain version on the CPU) to the
    in-process ``"cuda"`` fused replay."""
    em = _cuda_em(backend="cuda")
    em.storage.dir = str(tmp_path)
    jobs = [TS.generate("training_scan", n_steps=4, ckpt_every=2,
                        flops_per_step=4e7, hbm_per_step=2e6,
                        ckpt_bytes=2 << 20),
            TS.generate("fanout_straggler", n_workers=4, work_flops=2e7,
                        work_hbm=4e6, seed=1),
            TS.generate("serving_traffic", n_requests=2, n_params=1e6,
                        prefill_tokens=32, decode_tokens=4, seed=3)]
    want = [em.emulate(p) for p in jobs]
    em.storage.cleanup()
    rep = em.emulate_many(jobs, config=TF.FleetConfig.process(max_workers=1))
    assert [(r.consumed, r.n_samples, r.mode, r.n_dispatches)
            for r in rep.reports] == \
        [(r.consumed, r.n_samples, "fused", r.n_dispatches) for r in want]
    assert rep.recovery["worker_deaths"] == 0

"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``cuda``: they skip where there is no CUDA device.  This file
imports no JAX, so it runs on a machine that has the card and PyTorch
alone: ``python -m pytest -q -m cuda tests/test_torch_cuda.py``.
"""
import os
import sys
import threading

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.run import RunConfig
from repro_torch.core import Emulator, HostCalibration, SynapseProfile
from repro_torch.core import ResourceVector, Sample
from repro_torch.fleet import FleetConfig
from repro_torch.kernels.collective import kernel as wk, ref as wref
from repro_torch.kernels.compute_atom import kernel as ck, ref as cref
from repro_torch.kernels.flash_attention import kernel as fk, ref as fref
from repro_torch.kernels.memory_atom import kernel as mk, ops as mops
from repro_torch.kernels.memory_atom import ref as mref
from repro_torch.kernels.segment import kernel as sk, ref as sref
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.layers import attend_blocked, attend_full
from repro_torch.models.model_zoo import build_model
from repro_torch.models.params import map_tensors
from repro_torch.scenarios import generate
from repro_torch.serve.engine import Engine, Request

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402  (the repository's root holds it)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# tiles 64 and 256 run a burn in one cluster launch; 320 is above the
# cluster kernel's tiles and runs one launch an iteration
@pytest.mark.parametrize("tile,launches", [(64, 1), (256, 1), (320, 17)])
def test_burn_tile_matches_plain(dev, tile, launches):
    x = torch.from_numpy((np.random.default_rng(0).standard_normal(
        (tile, tile)) * 0.1).astype(np.float32)).to(dev)
    before = (ck.iterations, ck.launches)
    got = ck.burn_tile(x, iters=17)
    assert (ck.iterations, ck.launches) == (before[0] + 17,
                                            before[1] + launches)
    torch.testing.assert_close(got, cref.burn_tile(x, iters=17),
                               atol=1e-5, rtol=1e-5)


# the cluster burn's row pipeline (csrc/burn.cuh): fewer iterations than
# the panel's rows, one, an odd count (the double buffer's parity) and a
# long burn, at every cluster tile, on a random x
@pytest.mark.parametrize("tile", (64, 128, 256))
@pytest.mark.parametrize("iters", (1, 2, 3, 17, 1000))
def test_cluster_burn_matches_plain_at_every_count(dev, tile, iters):
    x = torch.from_numpy((np.random.default_rng(tile).standard_normal(
        (tile, tile)) * 0.1).astype(np.float32)).to(dev)
    got = ck.burn_tile(x, iters=iters)
    torch.testing.assert_close(got, cref.burn_tile(x, iters=iters),
                               atol=1e-5, rtol=1e-5)


# at x = 0.5 I, the emulation cells' operand, every sum has one nonzero
# term, so any order of it gives the benchmark reference's bits
@pytest.mark.parametrize("tile", (64, 128, 256))
def test_cluster_burn_at_half_identity_is_the_references_bits(dev, tile):
    from synbench.reference import emulation
    x = torch.eye(tile, dtype=torch.float32, device=dev) * 0.5
    for iters in (1, 2, 3, 17, 1000):
        assert torch.equal(ck.burn_tile(x, iters=iters),
                           emulation.burn(tile, iters, dev)), iters


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1 << 20, (1 << 20) + 13])
def test_stream_matches_plain(dev, dtype, n):
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(n)
                         .astype(np.float32)).to(dev, dtype)
    before = mk.launches
    got = mops.stream(x, iters=3, block=n)
    assert mk.launches == before + 3
    assert torch.equal(got, mref.stream_pass(mref.stream_pass(
        mref.stream_pass(x))))


def test_kernel_backend_counts_planned_launches(dev):
    tile, block = 64, 1 << 18
    prof = SynapseProfile(command="cuda", samples=[
        Sample(index=0, resources=ResourceVector(
            flops=5 * 2.0 * tile ** 3, hbm_bytes=3 * 2.0 * block))])
    em = Emulator(calib=HostCalibration(1e9, 1e9, 1e8, 1e8), backend="cuda",
                  compute_tile=tile, mem_block=block)
    ck.launches = ck.iterations = mk.ring_launches = mk.ring_passes = 0
    rep = em.emulate(prof, fused=False)
    # 5 iterations burned in one launch (one compute leg); 3 ring passes in
    # one launch (one memory leg)
    assert (ck.iterations, ck.launches) == (5, 1)
    assert (mk.ring_launches, mk.ring_passes) == (1, 3)
    assert rep.n_dispatches == 2 and rep.consumed == prof.totals
    # fused: one segment launch burns and streams them all
    sk.launches = sk.iterations = sk.passes = 0
    rep = em.emulate(prof)
    assert (rep.mode, rep.n_dispatches) == ("fused", 1)
    assert (sk.launches, sk.iterations, sk.passes) == (1, 5, 3)
    assert rep.consumed == prof.totals


# segment tables: zero rows (and the runner's pow2 padding), compute-only
# rows, memory-only rows, both in one row
SEGMENT_TABLES = [
    [[3, 2, 0], [0, 1, 0], [5, 0, 0], [0, 0, 0]],
    [[0, 0, 0], [7, 0, 0]],
    [[0, 4, 0]],
    [[2, 3, 0]] * 5,
    [[17, 0, 0], [0, 0, 0], [0, 9, 0], [1, 1, 0]],
]


@pytest.mark.parametrize("tile", sk.TILES)
@pytest.mark.parametrize("table", SEGMENT_TABLES)
def test_segment_matches_plain(dev, tile, table):
    """The burn carry to 1e-5 (exact float32 both sides, summed in other
    orders), the ring bit for bit, and the device counters exact."""
    rng = np.random.default_rng(4)
    t = np.asarray(table, np.int32)
    ci, mi = int(t[:, 0].sum()), int(t[:, 1].sum())
    x = torch.from_numpy((rng.standard_normal((tile, tile)) * 0.1).astype(
        np.float32)).to(dev)
    ring = mk.Ring(1 << 18, dev, slots=3)
    ring.data.copy_(torch.from_numpy(rng.standard_normal(
        (3, 1 << 16)).astype(np.float32)))
    ring.passes = 5
    want_ring = ring.data.clone()
    want_y = sref.run_segment(t, x, want_ring, start=5)
    before = (sk.launches, sk.iterations, sk.passes)
    run = sk.run_segment(t, x if ci else None, ring if mi else None)
    torch.cuda.synchronize()
    run.settle()
    assert (sk.launches - before[0], sk.iterations - before[1],
            sk.passes - before[2]) == (1, ci, mi)
    if ci:
        torch.testing.assert_close(run.y, want_y, atol=1e-5, rtol=1e-5)
    assert torch.equal(ring.data, want_ring)
    assert ring.passes == 5 + mi


@pytest.mark.parametrize("tile", sk.TILES)
@pytest.mark.parametrize("table", SEGMENT_TABLES)
def test_timed_segment_matches_plain_and_stamps_its_rows(dev, tile, table):
    """The timed kernel computes what the kernel does, and stamps the rows
    that ran, each no earlier than the one before, all after the first
    row's start (the last stamp), and no other row.  (The device's clock
    may tick in microseconds: a short row may read 0 ns.)"""
    rng = np.random.default_rng(5)
    t = np.asarray(table, np.int32)
    ci, mi = int(t[:, 0].sum()), int(t[:, 1].sum())
    x = torch.from_numpy((rng.standard_normal((tile, tile)) * 0.1).astype(
        np.float32)).to(dev)
    ring = mk.Ring(1 << 18, dev, slots=3)
    want_ring = ring.data.clone()
    want_y = sref.run_segment(t, x, want_ring, start=0)
    before = (sk.iterations, sk.passes)
    run = sk.run_segment(t, x if ci else None, ring if mi else None,
                         timed=True)
    torch.cuda.synchronize()
    run.settle()
    assert (sk.iterations - before[0], sk.passes - before[1]) == (ci, mi)
    if ci:
        torch.testing.assert_close(run.y, want_y, atol=1e-5, rtol=1e-5)
    assert torch.equal(ring.data, want_ring)
    stamps = run.stamps.cpu().numpy()
    assert stamps.shape == (len(t) + 1,)
    ran = t.any(axis=1)
    assert ((stamps[:-1] != 0) == ran).all()
    ends = stamps[:-1][ran]
    assert (np.diff(ends) >= 0).all() and ends[0] >= stamps[-1] > 0


# burn rows of one iteration each, between ring rows and zero rows: each
# burn row publishes its panel rows and the next one, after a grid
# barrier, waits for them
ONE_ITERATION_TABLES = [
    [[1, 0, 0], [0, 2, 0], [0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0],
     [0, 0, 0], [1, 0, 0]],
    [[0, 3, 0], [1, 0, 0], [0, 0, 0], [0, 0, 0], [1, 2, 0], [0, 1, 0],
     [1, 0, 0]],
]


@pytest.mark.parametrize("tile", sk.TILES)
@pytest.mark.parametrize("table", ONE_ITERATION_TABLES)
@pytest.mark.parametrize("timed", [False, True])
def test_segment_with_one_iteration_burn_rows(dev, tile, table, timed):
    """The burn carry to 1e-5, the ring bit for bit and the device
    counters exact, untimed and timed; timed, the burning CTAs' summed
    wait for y is no more than their summed burn time."""
    rng = np.random.default_rng(6)
    t = np.asarray(table, np.int32)
    ci, mi = int(t[:, 0].sum()), int(t[:, 1].sum())
    x = torch.from_numpy((rng.standard_normal((tile, tile)) * 0.1).astype(
        np.float32)).to(dev)
    ring = mk.Ring(1 << 18, dev, slots=3)
    want_ring = ring.data.clone()
    want_y = sref.run_segment(t, x, want_ring, start=0)
    before = (sk.launches, sk.iterations, sk.passes)
    run = sk.run_segment(t, x, ring, timed=timed)
    torch.cuda.synchronize()
    run.settle()
    assert (sk.launches - before[0], sk.iterations - before[1],
            sk.passes - before[2]) == (1, ci, mi)
    torch.testing.assert_close(run.y, want_y, atol=1e-5, rtol=1e-5)
    assert torch.equal(ring.data, want_ring)
    if timed:
        waited, burned = run.burn_ns.tolist()
        assert 0 <= waited <= burned and burned > 0
    else:
        assert run.burn_ns is None


def test_segment_counters_exact_under_threads(dev):
    """2 threads launch 40 segments each on one runner (one ring, one wire
    carry): the device counts every iteration, pass and collective step,
    the launches serialize on the shared stream, and nothing deadlocks."""
    from repro_torch.core.atoms import CollectiveAtom
    from repro_torch.core.schedule import FusedSegment, SegmentRunner
    runner = SegmentRunner(tile=256, block_bytes=1 << 20, device=dev,
                           backend="cuda", collective=CollectiveAtom(
                               make_mesh((2,), ("model",), dev),
                               backend="cuda"))
    seg = FusedSegment(table=[[3, 2, 1], [0, 1, 0], [4, 0, 2]])
    before = (sk.launches, sk.iterations, sk.passes, sk.steps,
              sk.wire_launches)
    start, errors = threading.Barrier(2), []

    def run():
        try:
            start.wait()
            for _ in range(40):
                assert runner.run(seg)
        except BaseException as e:        # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=run) for _ in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not errors and not any(th.is_alive() for th in threads)
    assert (sk.launches - before[0], sk.iterations - before[1],
            sk.passes - before[2], sk.steps - before[3],
            sk.wire_launches - before[4]) == (80, 80 * 7, 80 * 3, 80 * 3, 80)
    assert runner._ring().passes == 80 * 3
    assert torch.equal(runner._coll_operand(),
                       torch.ones_like(runner._coll_operand()))


def test_segment_and_ring_wrappers_raise_and_never_fall_back(dev):
    """CUDA tensors the kernels cannot take raise; no torch ops run in
    their place."""
    t = np.asarray([[2, 1, 0]], np.int32)
    before = (sk.launches, mk.ring_launches)
    ring = mk.Ring(1 << 18, dev, slots=2)
    with pytest.raises(ValueError, match="tile"):
        sk.run_segment(t, torch.eye(320, device=dev), ring)
    with pytest.raises(ValueError, match="tile"):
        sk.run_segment(t, torch.eye(64, device=dev, dtype=torch.float64),
                       ring)
    with pytest.raises(ValueError, match="lie on"):
        sk.run_segment(t, torch.eye(64), ring)
    with pytest.raises(ValueError, match="16-byte"):
        mk.stream_ring(mk.Ring(4 * 6, dev, slots=2), passes=1)
    from repro_torch.core.schedule import FusedSegment, SegmentRunner
    with pytest.raises(ValueError, match="tile"):
        SegmentRunner(tile=320, block_bytes=1 << 18, device=dev,
                      backend="cuda").run(FusedSegment(table=[[1, 0, 0]]))
    assert (sk.launches, mk.ring_launches) == before


# (shards shape, collective dim): a 2-shard mesh, a (2, 2) mesh along
# each axis, a 4-shard mesh whose inner is no multiple of 4 (one float a
# column), an inner of 16-byte vectors with several a thread and a ragged
# tail of them, 3 shards, an outer axis with a middle one, and all-gather
# blocks that are no multiple of 4 (10 beside an inner of 20 that is; 6)
COLL_SHAPES = [((2, 4096), 0), ((2, 2, 1024), 0), ((2, 2, 1024), 1),
               ((4, 333), 0), ((2, (1 << 22) + 12), 0), ((3, 4096), 0),
               ((2, 3, 2, 512), 1), ((3, 2, 10), 0), ((2, 2, 3, 6), 2)]


@pytest.mark.parametrize("kind", wref.KINDS)
@pytest.mark.parametrize("shape,dim", COLL_SHAPES)
def test_collective_matches_plain(dev, kind, shape, dim):
    """The per-sample collective against the plain version within 1e-6
    (float32; the sum over n shards in one order on both sides), one
    launch."""
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        shape).astype(np.float32)).to(dev)
    before = wk.launches
    got = wk.collective(x, dim=dim, kind=kind)
    want = wref.collective(x, dim=dim, kind=kind)
    torch.cuda.synchronize()
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert wk.launches - before == 1


def wire_limit(tile, dev):
    """The most shards a (n, 32768) carry may have at ``tile``."""
    return sk.max_wire_shards(tile, 1 << 15, sk.grid_info(tile, dev)["grid"],
                              sk.grid_info(tile, dev)["smem_limit"])


@pytest.mark.parametrize("kind", wref.KINDS)
@pytest.mark.parametrize("tile", sk.TILES)
@pytest.mark.parametrize("n", [1, 2, 3, 4, 8, "limit"])
def test_segment_wire_leg_matches_plain(dev, n, tile, kind):
    """The segment kernel's collective steps on an (n, 32768) carry (a
    1-shard axis, the axis of a 2-shard or a (2, 2) mesh, 3, 4 and 8
    shards, and the most shards whose share of shared memory fits beside
    the burn), after its burns and passes, against the plain walk within
    1e-6; the device counts every CTA's steps."""
    if n == "limit":
        n = wire_limit(tile, dev)
        assert n > 100
    rng = np.random.default_rng(7)
    t = np.asarray([[2, 1, 3], [0, 0, 0], [0, 0, 5], [1, 2, 0]], np.int32)
    x = torch.from_numpy((rng.standard_normal((tile, tile)) * 0.1).astype(
        np.float32)).to(dev)
    ring = mk.Ring(1 << 18, dev, slots=3)
    w = torch.from_numpy(rng.standard_normal((n, 1 << 15)).astype(
        np.float32)).to(dev)
    want_w, want_ring = w.clone(), ring.data.clone()
    want_y = sref.run_segment(t, x, want_ring, w=want_w, kind=kind)
    before = (sk.launches, sk.wire_launches, sk.steps)
    run = sk.run_segment(t, x, ring, w, kind)
    torch.cuda.synchronize()
    run.settle()
    assert (sk.launches - before[0], sk.wire_launches - before[1],
            sk.steps - before[2]) == (1, 1, 8)
    torch.testing.assert_close(run.w, want_w, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(run.y, want_y, atol=1e-5, rtol=1e-5)
    assert torch.equal(ring.data, want_ring)


@pytest.mark.parametrize("tile", sk.TILES)
def test_segment_without_wire_after_one_with_it(dev, tile):
    """A wire launch whose carry's share takes the shared memory past 48 KB
    (the opt-in), then one without wire rows at the same tile: each
    launches at its own shared memory (the kernel's sizes are the
    wrapper's plain functions), the grid cache keeps them apart, and both
    match the plain walk."""
    rng = np.random.default_rng(8)
    n = wire_limit(tile, dev)
    x = torch.from_numpy((rng.standard_normal((tile, tile)) * 0.1).astype(
        np.float32)).to(dev)
    plain = sk.grid_info(tile, dev)
    wired = sk.grid_info(tile, dev, (n, 1 << 15))
    assert plain["smem_bytes"] == sk.burn_smem_bytes(tile)
    assert wired["smem_bytes"] == sk.burn_smem_bytes(tile) + \
        sk.wire_share_bytes(n, 1 << 15, wired["grid"]) > 48 * 1024
    for t, w in (([[3, 1, 4], [2, 0, 1]], torch.from_numpy(
                     rng.standard_normal((n, 1 << 15)).astype(np.float32))
                  .to(dev)),
                 ([[3, 1, 0], [2, 2, 0]], None)):
        t = np.asarray(t, np.int32)
        ring = mk.Ring(1 << 18, dev, slots=3)
        want_w = None if w is None else w.clone()
        want_ring = ring.data.clone()
        want_y = sref.run_segment(t, x, want_ring, w=want_w)
        run = sk.run_segment(t, x, ring, w)
        torch.cuda.synchronize()
        run.settle()
        torch.testing.assert_close(run.y, want_y, atol=1e-5, rtol=1e-5)
        assert torch.equal(ring.data, want_ring)
        if w is not None:
            torch.testing.assert_close(run.w, want_w, rtol=1e-6, atol=1e-6)
    assert sk.grid_info(tile, dev) == plain


def test_segment_wire_carry_beyond_the_limit_raises(dev):
    """A carry one shard beyond the limit raises, naming it, before any
    launch: no counter moves and the ring numbers no pass."""
    n = wire_limit(256, dev) + 1
    x = torch.eye(256, device=dev)
    ring = mk.Ring(1 << 18, dev, slots=2)
    w = torch.ones((n, 1 << 15), device=dev)
    before = (sk.launches, sk.wire_launches, sk.steps, ring.passes)
    with pytest.raises(ValueError, match="beyond the limit of"):
        sk.run_segment(np.asarray([[1, 1, 1]], np.int32), x, ring, w)
    assert (sk.launches, sk.wire_launches, sk.steps, ring.passes) == before
    assert torch.equal(w, torch.ones_like(w))


def test_mesh_bound_replay_on_the_card(dev):
    """A 2-shard mesh on the card: fused replay launches one segment with
    its wire rows, per sample one collective a wire leg; both consume the
    profile's totals and emulate the same quantized wire bytes."""
    em = Emulator(calib=HostCalibration(1e9, 1e9, 1e8, 1e8), backend="cuda",
                  compute_tile=64, mem_block=1 << 18,
                  mesh=make_mesh((2,), ("model",), dev), device=dev)
    rvs = [ResourceVector(flops=2.0 * 64 ** 3 * (1 + i % 2),
                          ici_bytes={"all-reduce": 2e6 * (1 + i % 2)})
           for i in range(6)]
    prof = SynapseProfile(command="wire", samples=[
        Sample(index=i, resources=r) for i, r in enumerate(rvs)])
    before = (sk.launches, sk.steps, wk.launches)
    fused = em.emulate(prof, fused=True)
    torch.cuda.synchronize()
    table = em.compile(prof).segments[0].table
    assert (sk.launches - before[0], sk.steps - before[1],
            wk.launches - before[2]) == (1, int(table[:, 2].sum()), 0)
    before = wk.launches
    per_sample = em.emulate(prof, fused=False)
    assert wk.launches - before == 6
    assert fused.consumed == per_sample.consumed == prof.totals
    assert fused.n_collective_dispatches == per_sample.n_collective_dispatches
    assert abs(fused.emulated_ici_bytes - prof.totals.ici_total) \
        < 0.05 * prof.totals.ici_total
    with pytest.raises(ValueError, match="emulator's device"):
        Emulator(calib=HostCalibration(1e9, 1e9, 1e8, 1e8), device=dev,
                 mesh=make_mesh((2,), ("model",), "cpu"))


def test_ring_pass_matches_plain(dev):
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (3, 1 << 20)).astype(np.float32)).to(dev)
    ring = mk.Ring(1 << 22, dev, slots=3)
    ring.data.copy_(x)
    before = (mk.ring_launches, mk.ring_passes)
    mk.stream_ring(ring, passes=4)
    mk.stream_ring(ring, passes=3)
    mref.ring_pass(x, start=0, passes=7)
    torch.cuda.synchronize()
    assert (mk.ring_launches - before[0], mk.ring_passes - before[1]) == \
        (2, 7)
    assert torch.equal(ring.data, x)


def test_ring_outruns_the_l2(dev):
    """The atom's ring holds at least 4 x the L2's bytes (13 blocks of 16
    MiB for an H100's 50 MiB)."""
    from repro_torch.core.atoms import MemoryAtom
    atom = MemoryAtom(block_bytes=1 << 24, backend="cuda", device=dev)
    ring = atom.ring()
    assert ring.slots * (1 << 24) >= 4 * mk.l2_cache_bytes(dev)
    assert (ring.slots - 1) * (1 << 24) < 4 * mk.l2_cache_bytes(dev)


def test_torch_memory_leg_streams_device_memory(dev):
    """The ``"torch"`` backend's memory leg passes in place over the atom's
    ring (4 x the L2's bytes): a pass faster than 1.05 x the HBM rate would
    be reading L2, and fails here as in ``chip_smoke.py``'s main path."""
    from repro_torch.core.atoms import MemoryAtom
    ring = MemoryAtom(block_bytes=1 << 24, backend="torch", device=dev).ring()
    assert ring.slots * (1 << 24) >= 4 * mk.l2_cache_bytes(dev)
    ms, rate, slots = chip_smoke.torch_ring_pass_ms(torch)
    assert slots == ring.slots
    assert rate <= chip_smoke.RING_MAX_OF_HBM * chip_smoke.PEAK_HBM_BPS, ms


def test_static_profile_on_the_card_equals_meta_and_cpu(dev):
    """``profile_step`` counts the same on the card, on meta tensors and on
    the CPU; on the card the flash kernel launches once a layer, and its
    custom op is charged the pairs its mask leaves."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.core import profile_step
    cfg = ModelConfig(name="tiny-lm", family="dense", num_layers=2,
                      d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
                      d_ff=128, vocab_size=128, tie_embeddings=True)
    model = build_model(cfg, RunConfig(attn_impl="cuda", param_dtype="float32",
                                       compute_dtype="float32"))
    params = model.init(torch.Generator(dev).manual_seed(0), dev)
    batch = {"tokens": torch.randint(0, 128, (2, 32), dtype=torch.int32,
                                     device=dev)}

    def fn(p, b):
        with torch.inference_mode():
            return model.logits(p, model.forward(p, b)[0])

    costs, launches = {}, {}
    for where in ("cuda", "meta", "cpu"):
        before = fk.launches
        prof, costs[where] = profile_step(fn, params, batch, command="t",
                                          device=where)
        launches[where] = fk.launches - before
        assert [s.label for s in prof.samples] == [
            "glue", "scan:layers", "scan:layers", "glue"]
    assert costs["cuda"] == costs["meta"] == costs["cpu"]
    assert launches == {"cuda": 2, "meta": 0, "cpu": 0}
    assert costs["cuda"].op_flops["synapse.flash_attention"] == \
        2 * fref.flops(8, 32, 32, 16, causal=True)


# (BH, BKV, Sq, Sk, hd, causal, window, softcap): the JAX package's SWEEP
# (tests/test_kernels.py), Gemma2's head dim, a ragged length, then unequal
# lengths and windows that leave rows with no visible key
FLASH = [
    (2, 2, 64, 64, 16, True, None, None),
    (2, 2, 64, 64, 16, True, 9, None),
    (2, 2, 64, 64, 16, True, None, 30.0),
    (4, 2, 32, 32, 8, True, None, None),
    (3, 1, 48, 48, 32, False, None, None),
    (2, 2, 128, 128, 64, True, 40, 25.0),
    (4, 2, 256, 256, 256, True, 40, 50.0),
    (8, 2, 300, 300, 128, True, None, None),
    (4, 2, 100, 37, 64, True, None, None),          # Sq > Sk
    (2, 1, 24, 40, 16, False, 7, None),             # Sq < Sk
    (2, 1, 37, 100, 128, True, 16, 30.0),           # Sq < Sk, window
    (4, 2, 40, 24, 16, True, 5, None),              # rows 28.. see no key
    (2, 1, 96, 40, 256, True, 20, None),            # rows 60.. see no key
    (2, 2, 64, 64, 32, True, 0, None),              # window 0: no row
    (2, 2, 64, 64, 32, False, 0, 30.0),             # window 0, not causal
]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("case", FLASH)
def test_flash_attention_matches_plain(dev, case, dtype, tol):
    BH, BKV, Sq, Sk, hd, causal, window, softcap = case
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.standard_normal((n, S, hd)).astype(
        np.float32)).to(dev, dtype) for n, S in ((BH, Sq), (BKV, Sk),
                                                 (BKV, Sk)))
    kw = dict(causal=causal, window=window, softcap=softcap,
              group=BH // BKV)
    before = fk.launches
    got = fk.flash_attention(q, k, v, block_q=Sq, block_kv=Sk, **kw)
    assert fk.launches == before + 1
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(),
                               fref.flash_attention(q, k, v, **kw).float(),
                               atol=tol, rtol=tol)


# (BH, BKV, Sq, Sk, hd, causal, window, softcap): the float32 kernel's
# edges (csrc/flash_attention.cu): every head-dim template, lengths that
# are no multiple of its tiles (128 rows and keys; 64 at hd 256), Sq != Sk
# both ways, group 7, windows that leave rows with no key, window 0,
# softcap, no mask, and enough kv tiles that its ring of 3 half-tile
# stages wraps many times
FLASH_F32_EDGES = [
    (2, 1, 300, 300, 8, True, None, None),
    (2, 1, 300, 300, 64, True, None, None),
    (2, 1, 300, 300, 96, True, None, None),
    (2, 1, 300, 300, 128, True, None, None),
    (2, 1, 300, 300, 200, True, None, None),
    (2, 1, 300, 300, 256, True, None, None),
    (4, 2, 300, 200, 128, True, None, None),        # Sq > Sk
    (4, 2, 200, 333, 64, True, None, None),         # Sq < Sk
    (4, 2, 333, 129, 256, False, None, None),       # Sq > Sk, no mask
    (14, 2, 260, 260, 128, True, None, None),       # group 7
    (14, 2, 150, 150, 64, True, 33, 20.0),          # group 7, window, cap
    (2, 1, 300, 100, 128, True, 20, None),          # rows 120.. see no key
    (2, 1, 300, 100, 256, True, 20, None),          # the same at hd 256
    (2, 2, 200, 200, 128, True, 0, None),           # window 0: no row
    (2, 2, 200, 200, 64, False, 0, 30.0),           # window 0, not causal
    (2, 1, 257, 300, 128, False, None, 50.0),       # not causal, softcap
    (2, 1, 1000, 1000, 128, True, None, None),      # 8 kv tiles
    (2, 1, 1000, 1000, 64, False, 300, None),       # a window, not causal
    (2, 1, 600, 600, 256, True, None, 30.0),        # 10 kv tiles of 64
]


@pytest.mark.parametrize("case", FLASH_F32_EDGES)
def test_flash_attention_f32_edges_match_plain(dev, case):
    BH, BKV, Sq, Sk, hd, causal, window, softcap = case
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal((n, S, hd)).astype(
        np.float32)).to(dev) for n, S in ((BH, Sq), (BKV, Sk), (BKV, Sk)))
    kw = dict(causal=causal, window=window, softcap=softcap,
              group=BH // BKV)
    before = fk.launches
    got = fk.flash_attention(q, k, v, block_q=Sq, block_kv=Sk, **kw)
    assert fk.launches == before + 1
    torch.testing.assert_close(got, fref.flash_attention(q, k, v, **kw),
                               atol=2e-5, rtol=2e-5)


def test_reduced_engine_serves_the_same_tokens_with_the_kernel(dev):
    """float32, so the kernel and the dense path agree far inside a logit
    gap; greedy tokens must be identical."""
    f32 = dict(param_dtype="float32", compute_dtype="float32",
               cache_dtype="float32")
    cfg = reduced_config(get_config("qwen2-7b"))
    rng = np.random.default_rng(3)
    spec = [(list(rng.integers(0, cfg.vocab_size, n)), m)
            for n, m in ((5, 6), (9, 4), (3, 8), (7, 5), (4, 3))]
    outs, params = {}, None
    for impl in ("full", "cuda"):
        model = build_model(cfg, RunConfig(attn_impl=impl, **f32))
        if params is None:
            params = model.init(torch.Generator(dev).manual_seed(0), dev)
        before = fk.launches
        reqs = Engine(model, params, batch_slots=4, max_len=32).serve(
            [Request(prompt=p, max_new_tokens=m) for p, m in spec])
        waves = -(-len(spec) // 4)
        assert fk.launches - before == (cfg.num_layers * waves
                                        if impl == "cuda" else 0)
        outs[impl] = [r.out_tokens for r in reqs]
    assert outs["cuda"] == outs["full"]


def test_kernel_counters_exact_under_threads(dev):
    """A thread fleet on the kernel backend burns and streams from several
    threads at once: 4 threads x 50 burns and 4 x 50 streams, with the
    interpreter switching threads as often as it can, lose no count."""
    x = torch.full((64, 64), 0.01, device=dev)
    y = torch.ones(1 << 16, device=dev)
    before = (ck.launches, ck.iterations, mk.launches)
    start, errors = threading.Barrier(8), []

    def run(fn):
        try:
            start.wait()
            for _ in range(50):
                fn()
        except BaseException as e:        # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(
        lambda: ck.burn_tile(x, iters=3),)) for _ in range(4)] + [
        threading.Thread(target=run, args=(
            lambda: mk.stream_passes(y, block=1 << 16, passes=2),))
        for _ in range(4)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    torch.cuda.synchronize()
    assert not errors and not any(t.is_alive() for t in threads)
    # tile 64 burns in one launch; a stream launches once a pass
    assert (ck.launches - before[0], ck.iterations - before[1],
            mk.launches - before[2]) == (200, 600, 400)


def test_process_fleet_on_the_card(dev):
    """2 spawned workers on the card, on the fused ``"torch"`` backend:
    each report equals the in-process replay, and each worker names the
    card it runs on."""
    em = Emulator(calib=HostCalibration(1e9, 1e9, 1e8, 1e8),
                  compute_tile=64, mem_block=1 << 18)
    jobs = [generate("fanout_straggler", n_workers=4, work_flops=2e7,
                     work_hbm=4e6), generate("retry_storm", seed=2),
            generate("mixed_fleet", total_samples=8, seed=1)]
    want = [em.emulate(p, fused=True) for p in jobs]
    em.storage.cleanup()
    rep = em.emulate_many(jobs, config=FleetConfig.process(max_workers=2))
    assert [(r.consumed, r.n_samples, r.mode) for r in rep.reports] == \
        [(r.consumed, r.n_samples, "fused") for r in want]
    assert rep.recovery["worker_deaths"] == 0
    from repro_torch.fleet import ProcessFleet, WorkerSpec
    with ProcessFleet(2, WorkerSpec(emulator=em.spec(),
                                    device=str(em.device))) as pf:
        infos = pf.warmup(timeout=300.0)
    assert [i["device"] for i in infos] == \
        [torch.cuda.get_device_name(0)] * 2


def test_standing_fleet_session_on_the_card(dev):
    """A warm 1-worker ``StandingFleet`` on the card serves a 2-request
    session: both requests replay fused on the card's worker, each to the
    in-process replay's consumed amounts."""
    from repro_torch.service import StandingFleet
    em = Emulator(calib=HostCalibration(1e9, 1e9, 1e8, 1e8),
                  compute_tile=64, mem_block=1 << 18)
    jobs = [generate("fanout_straggler", n_workers=4, work_flops=2e7,
                     work_hbm=4e6), generate("retry_storm", seed=2)]
    want = [em.emulate(p, fused=True).consumed for p in jobs]
    em.storage.cleanup()
    got = {}
    with StandingFleet(em, FleetConfig.process(max_workers=1)) as sf:
        info, = sf.warmup(timeout=300.0)
        sf.on_complete(lambda rec, rep: got.update({rec.idx: rep}))
        for p in jobs:
            sf.submit(p)
        res = sf.drain(timeout=300.0)
    assert info["device"] == torch.cuda.get_device_name(0)
    assert res.n_ok == 2 and [r.ok for r in res.records] == [True, True]
    assert [got[i].consumed for i in range(2)] == want
    assert all(got[i].mode == "fused" for i in range(2))


def test_process_fleet_on_the_card_replays_segment_kernels(dev):
    """A worker given the ``"cuda"`` backend replays fused through the
    segment kernel on the card (its device counters checked in the
    worker, which raises on a short burn): reports equal the in-process
    ``"cuda"`` replay, which launches one segment a non-noop segment."""
    em = Emulator(calib=HostCalibration(1e9, 1e9, 1e8, 1e8), backend="cuda",
                  compute_tile=64, mem_block=1 << 18)
    jobs = [generate("fanout_straggler", n_workers=4, work_flops=2e7,
                     work_hbm=4e6), generate("retry_storm", seed=2),
            generate("mixed_fleet", total_samples=8, seed=1)]
    sk.launches = 0
    want = [em.emulate(p) for p in jobs]
    em.storage.cleanup()
    assert sk.launches == sum(
        1 for p in jobs for s in em.compile(p).segments
        if s.compute_iters or s.memory_iters) > 0
    rep = em.emulate_many(jobs, config=FleetConfig.process(max_workers=1))
    assert [(r.consumed, r.n_samples, r.mode, r.n_dispatches)
            for r in rep.reports] == \
        [(r.consumed, r.n_samples, "fused", r.n_dispatches) for r in want]


@pytest.mark.parametrize("dtype,window", [(torch.float32, None),
                                          (torch.float32, 128),
                                          (torch.bfloat16, None)])
def test_blocked_attention_matches_dense_on_the_card(dev, dtype, window):
    """Both blocked paths (flash; banded for the window) against dense
    attention at Qwen2-7B's heads: float32 forward 2e-5 and dq/dk/dv 3e-5,
    bf16 forward 2e-2 (the JAX package's tolerances)."""
    S = 1024
    g = torch.Generator(dev).manual_seed(0)
    q, w = (torch.randn((1, S, 4, 7, 128), generator=g, device=dev)
            .to(dtype) for _ in range(2))
    k, v = (torch.randn((1, S, 4, 128), generator=g, device=dev).to(dtype)
            for _ in range(2))
    pos = torch.arange(S, device=dev)
    outs, grads = [], []
    for fn in (lambda *a: attend_blocked(*a, causal=True, window=window,
                                         softcap=None, block_q=128,
                                         block_kv=256),
               lambda *a: attend_full(*a, q_pos=pos, k_pos=pos, causal=True,
                                      window=window, softcap=None)):
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = fn(*leaves)
        outs.append(out.detach().float())
        grads.append([x.float() for x in torch.autograd.grad(out, leaves,
                                                             w)])
    if dtype == torch.bfloat16:
        torch.testing.assert_close(outs[0], outs[1], atol=2e-2, rtol=2e-2)
        return
    torch.testing.assert_close(outs[0], outs[1], atol=2e-5, rtol=2e-5)
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=3e-5, rtol=3e-5)


@pytest.mark.parametrize("seed,batch_step", [(0, 0), (1, 5)])
def test_tiny_train_step_on_the_card_matches_the_cpu(dev, seed, batch_step):
    """The tiny config of tests/test_train_loop.py: one step on the card
    against the same step on the CPU, float32 with TF32 off, within the
    bounds of chip_smoke.py's train phase (its ``TINY_*_TOL``), which runs
    the same helper over more seeds; the same step with TF32 matmuls on
    the card falls outside them."""
    errs = chip_smoke.tiny_step_errors(torch, dev, seed, batch_step)
    assert errs["ok"], errs
    planted = chip_smoke.tiny_step_errors(torch, dev, seed, batch_step,
                                          tf32=True)
    assert not planted["ok"], planted


FAMILY_ARCHS = ["llama4-scout-17b-a16e", "moonshot-v1-16b-a3b",
                "qwen2-vl-2b", "mamba2-780m", "hymba-1.5b",
                "seamless-m4t-medium"]


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_forward_and_greedy_steps_on_the_card_match_the_cpu(dev,
                                                                    arch):
    """Each family's reduced model in float32, the same weights on the
    card ("cuda" attention: the flash kernel) and on the CPU (its plain
    version): final hidden states within 1e-4 of their largest magnitude
    (at least 1), identical greedy tokens of a prefill and 3 decode
    steps."""
    f32 = dict(param_dtype="float32", compute_dtype="float32",
               cache_dtype="float32")
    cfg = reduced_config(get_config(arch))
    model = build_model(cfg, RunConfig(attn_impl="cuda", **f32))
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    S, src = (8, 16) if cfg.family == "encdec" else (16, 0)
    batch = chip_smoke.family_batch(torch, np, cfg, torch.float32, 2, S,
                                    torch.device("cpu"), seed=1, src=src)
    out = {}
    for where in ("cpu", dev):
        p = map_tensors(params, lambda t: t.to(where))
        b = {k: v.to(where) for k, v in batch.items()}
        with torch.inference_mode():
            out[str(where)] = chip_smoke.greedy_steps(
                model, p, b, 3, S + 3, src_len=src)
    (t_cpu, h_cpu), (t_card, h_card) = out["cpu"], out[str(dev)]
    assert t_card == t_cpu
    scale = max(1.0, h_cpu.abs().max().item())
    assert (h_card.cpu() - h_cpu).abs().max().item() <= 1e-4 * scale


def test_ssd_scan_on_the_card_matches_its_oracle(dev):
    """The chunked SSD scan against the recurrent oracle on the card, at
    the JAX package's test sizes (tests/test_model_correctness.py) and a
    ragged length, within its 1e-4; the gradients stay finite where the
    decay overflows float32."""
    import torch.nn.functional as F
    from repro_torch.models import ssm
    g = torch.Generator(dev).manual_seed(2)
    for L, chunk, G in ((32, 8, 1), (32, 4, 2), (30, 8, 1)):
        x = torch.randn((2, L, 4, 8), generator=g, device=dev)
        dt = F.softplus(torch.randn((2, L, 4), generator=g, device=dev))
        A = -torch.exp(0.5 * torch.randn((4,), generator=g, device=dev))
        Bm = torch.randn((2, L, G, 16), generator=g, device=dev)
        Cm = torch.randn((2, L, G, 16), generator=g, device=dev)
        y, s = ssm.ssd_chunked(x, dt, A, Bm, Cm, chunk=chunk,
                               return_state=True)
        ry, rs = ssm.ssd_reference(x, dt, A, Bm, Cm)
        torch.testing.assert_close(y, ry, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(s, rs, atol=1e-4, rtol=1e-4)
    leaves = [t.detach().requires_grad_() for t in (x, dt * 40, A, Bm, Cm)]
    ssm.ssd_chunked(*leaves, chunk=8).square().sum().backward()
    assert all(torch.isfinite(t.grad).all() for t in leaves)


def _rank_collectives(rank, dev_name, blk):
    """On each of two ranks sharing the card: every kind of ``RankMesh``
    collective against its plain version on all ranks' blocks, and a
    DTensor gathered whole; returns the largest errors."""
    from torch.distributed.tensor import Shard, distribute_tensor
    from repro_torch.launch import world
    dev = torch.device(dev_name)
    mesh = world.RankMesh((2,), ("model",), dev)
    blocks = torch.from_numpy(blk).to(dev)
    errs = {}
    for kind in wref.KINDS:
        want = wref.collective(blocks, dim=0, kind=kind)[rank]
        got = mesh.collective(blocks[rank].clone(), "model", kind)
        errs[kind] = float((got - want).abs().max())
    dmesh = world.device_mesh((2,), ("model",), dev)
    whole = distribute_tensor(blocks, dmesh, (Shard(0),),
                              src_data_rank=None).full_tensor()
    errs["dtensor_gather"] = float((whole - blocks).abs().max())
    return errs


def test_rank_mesh_collectives_on_the_card(dev, tmp_path):
    """Two gloo ranks on the one card (NCCL takes a card a rank): the
    collectives move the right values, the all-gather through the host
    (gloo's functional one ends both ranks on CUDA tensors)."""
    from repro_torch.launch import world
    blk = np.random.default_rng(4).standard_normal((2, 4096)).astype(
        np.float32)
    errs = world.spawn(_rank_collectives, 2, "cuda", blk,
                       store=str(tmp_path), backend="gloo", device="cuda",
                       timeout=300)
    assert errs["all-gather"] == errs["collective-permute"] == 0.0
    assert errs["dtensor_gather"] == 0.0
    assert errs["all-reduce"] <= 1e-6

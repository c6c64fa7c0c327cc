"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``cuda``: they skip where there is no CUDA device.  This file
imports no JAX, so it runs on a machine that has the card and PyTorch
alone: ``python -m pytest -q -m cuda tests/test_torch_cuda.py``.
"""
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
from repro_torch.kernels.compute_atom import kernel as ck, ref as cref
from repro_torch.kernels.flash_attention import kernel as fk, ref as fref
from repro_torch.kernels.memory_atom import kernel as mk, ops as mops
from repro_torch.kernels.memory_atom import ref as mref
from repro_torch.models.model_zoo import build_model
from repro_torch.scenarios import generate
from repro_torch.serve.engine import Engine, Request

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
    ck.launches = ck.iterations = mk.launches = 0
    rep = em.emulate(prof)
    # 5 iterations burned in one launch (one compute leg); 3 stream passes
    assert (ck.iterations, ck.launches) == (5, 1)
    assert mk.launches == 3
    assert rep.n_dispatches == 2 and rep.consumed == prof.totals


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

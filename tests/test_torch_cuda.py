"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``cuda``: they skip where there is no CUDA device.  This file
imports no JAX, so it runs on a machine that has the card and PyTorch
alone: ``python -m pytest -q -m cuda tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import Emulator, HostCalibration, SynapseProfile
from repro_torch.core import ResourceVector, Sample
from repro_torch.kernels.compute_atom import kernel as ck, ref as cref
from repro_torch.kernels.memory_atom import kernel as mk, ops as mops
from repro_torch.kernels.memory_atom import ref as mref

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("tile", [64, 256])
def test_burn_tile_matches_plain(dev, tile):
    x = torch.from_numpy((np.random.default_rng(0).standard_normal(
        (tile, tile)) * 0.1).astype(np.float32)).to(dev)
    before = ck.launches
    got = ck.burn_tile(x, iters=17)
    assert ck.launches == before + 17
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
    ck.launches = mk.launches = 0
    rep = em.emulate(prof)
    assert (ck.launches, mk.launches) == (5, 3)
    assert rep.n_dispatches == 2 and rep.consumed == prof.totals

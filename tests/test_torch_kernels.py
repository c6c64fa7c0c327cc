"""The port's kernels against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; those are held to
the Pallas kernels in interpret mode at the JAX package's own tolerances
(``tests/test_kernels.py``).  ``tests/test_torch_cuda.py`` holds the CUDA
kernels to the plain versions on a card.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.compute_atom import kernel as ck, ops as cops, ref as cref
from repro.kernels.memory_atom import kernel as mk, ops as mops, ref as mref
from repro_torch.kernels.compute_atom import kernel as tck
from repro_torch.kernels.compute_atom import ops as tcops
from repro_torch.kernels.compute_atom import ref as tcref
from repro_torch.kernels.memory_atom import kernel as tmk
from repro_torch.kernels.memory_atom import ops as tmops
from repro_torch.kernels.memory_atom import ref as tmref


def _tile(tile, seed=0):
    return (np.random.default_rng(seed).standard_normal((tile, tile))
            * 0.1).astype(np.float32)


# ---------------------------------------------------------------------------
# compute atom
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tile", [8, 64, 128])
@pytest.mark.parametrize("iters", [1, 3, 17])
def test_burn_tile_matches_pallas(tile, iters):
    x = _tile(tile)
    got = tck.burn_tile(torch.from_numpy(x), iters=iters).numpy()
    pallas = np.asarray(ck.burn_tile(jnp.asarray(x), iters=iters,
                                     interpret=True))
    oracle = np.asarray(cref.burn_tile(jnp.asarray(x), iters=iters))
    np.testing.assert_allclose(got, pallas, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, oracle, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("tile", [64, 128, 256])
@pytest.mark.parametrize("panel", ["first", "middle", "last"])
def test_burn_chain_is_row_separable(tile, panel):
    """The CUDA kernel runs a whole burn in one launch because a panel of
    rows needs no other rows: the chain started from x[R] gives rows R of
    the whole chain.  Not bitwise: the CPU's GEMM may block a row panel
    differently."""
    x = torch.from_numpy(_tile(tile, seed=3))
    p = {"first": 0, "middle": tile // 32, "last": tile // 16 - 1}[panel]
    rows = slice(16 * p, 16 * p + 16)      # the kernel's panel of 16 rows
    iters = 17
    y = x[rows]
    for _ in range(iters):
        y = (y @ x) * 0.5 + 0.25
    torch.testing.assert_close(y, tcref.burn_tile(x, iters=iters)[rows],
                               atol=1e-6, rtol=1e-6)


def test_burn_ops_default_operand_and_flops():
    got = tcops.burn(iters=4, tile=64, device="cpu")
    want = np.asarray(cops.burn(iters=4, tile=64))
    assert got.shape == (64, 64) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    for tile, iters in [(8, 1), (64, 4), (256, 1000)]:
        assert tcref.flops(tile, iters) == cref.flops(tile, iters)


def test_burn_zero_iters_is_identity_copy():
    x = torch.from_numpy(_tile(16))
    out = tck.burn_tile(x, iters=0)
    assert torch.equal(out, x) and out.data_ptr() != x.data_ptr()


# ---------------------------------------------------------------------------
# memory atom
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,block", [(256, 64), (1024, 1024), (4096, 512)])
def test_stream_pass_matches_pallas(n, block, dtype):
    base = np.arange(n, dtype=np.float32)
    jx = jnp.asarray(base).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(base).to(getattr(torch, dtype))
    got = tmk.stream_pass(tx, block=block).float().numpy()
    pallas = np.asarray(mk.stream_pass(jx, block=block, interpret=True),
                        np.float32)
    if dtype == "float32":
        np.testing.assert_array_equal(got, pallas)          # bitwise
    else:
        np.testing.assert_allclose(got, pallas, rtol=1e-2)
    np.testing.assert_allclose(got, np.asarray(mref.stream_pass(jx),
                                               np.float32), rtol=1e-2)


def test_stream_multi_pass_matches_pallas():
    x = np.ones((2048,), np.float32)
    want = np.asarray(mops.stream(jnp.asarray(x), iters=5, block=256))
    got = tmops.stream(torch.from_numpy(x), iters=5, block=256).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, x * 1.0000001 ** 5, rtol=1e-5)
    assert tmref.bytes_moved(2048 * 4, 5) == mref.bytes_moved(2048 * 4, 5)


@pytest.mark.parametrize("block_bytes", [1024, 2048 * 4, 1 << 20])
def test_stream_with_block_bytes(block_bytes):
    """``block_bytes`` is a plain int here; the JAX package's ``stream``
    cannot run with it set (its jit traces it, ops.py:9-14), so the
    reference is the same passes with the block given directly."""
    x = np.random.default_rng(1).standard_normal(2048).astype(np.float32)
    block = min(block_bytes // 4, 2048)
    want = np.asarray(mops.stream(jnp.asarray(x), iters=3, block=block))
    got = tmops.stream(torch.from_numpy(x), iters=3,
                       block_bytes=block_bytes).numpy()
    np.testing.assert_array_equal(got, want)


def test_bytes_accounting():
    for nbytes, passes in [(4, 1), (1 << 24, 3), (1 << 26, 1000)]:
        assert tmref.bytes_moved(nbytes, passes) == \
            mref.bytes_moved(nbytes, passes)


# ---------------------------------------------------------------------------
# wrappers: input checks and launch counters
# ---------------------------------------------------------------------------

def test_cpu_runs_count_no_launches():
    tck.launches = tmk.launches = 0
    tck.burn_tile(torch.from_numpy(_tile(64)), iters=3)
    tmops.stream(torch.ones(4096), iters=4, block_bytes=1 << 12)
    assert (tck.launches, tmk.launches) == (0, 0)


@pytest.mark.parametrize("x,iters,err", [
    (torch.ones(12, 12), 1, ValueError),                # tile % 8
    (torch.ones(8, 16), 1, ValueError),                 # not square
    (torch.ones(8), 1, ValueError),                     # not 2-D
    (torch.ones(8, 8, dtype=torch.float64), 1, TypeError),
    (torch.ones(8, 8, dtype=torch.bfloat16), 1, TypeError),
    (torch.ones(16, 16).t()[:8, :8], 1, ValueError),    # not contiguous
    (torch.ones(8, 8), -1, ValueError),
    (np.ones((8, 8), np.float32), 1, TypeError),
])
def test_burn_tile_rejects(x, iters, err):
    with pytest.raises(err):
        tck.burn_tile(x, iters=iters)


@pytest.mark.parametrize("x,block,err", [
    (torch.ones(100), 64, ValueError),                  # n % block
    (torch.ones(64), 0, ValueError),
    (torch.ones(8, 8), 8, ValueError),                  # not 1-D
    (torch.ones(0), 1, ValueError),
    (torch.ones(64, dtype=torch.float16), 64, TypeError),
    (torch.ones(64, dtype=torch.int32), 64, TypeError),
    (torch.ones(128)[::2], 64, ValueError),             # not contiguous
])
def test_stream_pass_rejects(x, block, err):
    with pytest.raises(err):
        tmk.stream_pass(x, block=block)


def test_loader_binds_every_c_function_with_its_arity():
    """ctypes trusts the declared argument types; each C function the
    sources export is declared, with as many arguments as it takes."""
    from repro_torch.kernels import build
    text = "\n".join(p.read_text() for p in build.sources())
    exported = {name: len(params.split(",")) for name, params in
                re.findall(r'extern "C"[^(]*?(\w+)\(([^)]*)\)', text)}
    assert exported == {name: len(argtypes) for name, (_, argtypes)
                        in build.SIGNATURES.items()}

"""The port's flash attention against the JAX package's.

On the CPU the wrapper runs its plain version (``ref.flash_attention``);
it is held to the Pallas kernel in interpret mode and to the JAX oracle at
the JAX package's own tolerances (``tests/test_kernels.py``): 2e-5 in
float32, 2e-2 in bfloat16.  ``tests/test_torch_cuda.py`` holds the CUDA
kernel to the plain version on a card.
"""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import kernel as fk, ops as fops
from repro.kernels.flash_attention import ref as fref
from repro.models.layers import attend_full as j_attend_full
from repro_torch.kernels.flash_attention import kernel as tk, ops as tops
from repro_torch.kernels.flash_attention import ref as tref
from repro_torch.models.layers import attend_full as t_attend_full

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import FLASH_TOL  # noqa: E402  (the repository's root)

SWEEP = [
    # (BH, BKV, S, hd, bq, bkv, causal, window, softcap)
    (2, 2, 64, 16, 16, 16, True, None, None),
    (2, 2, 64, 16, 32, 16, True, 9, None),
    (2, 2, 64, 16, 16, 32, True, None, 30.0),
    (4, 2, 32, 8, 8, 8, True, None, None),     # GQA group=2
    (3, 1, 48, 32, 16, 16, False, None, None),  # cross-attn-like, group=3
    (2, 2, 128, 64, 64, 32, True, 40, 25.0),
]


def _qkv(BH, BKV, S, hd, seed, Sk=None):
    rng = np.random.default_rng(seed)
    Sk = S if Sk is None else Sk
    return (rng.standard_normal((BH, S, hd)).astype(np.float32),
            rng.standard_normal((BKV, Sk, hd)).astype(np.float32),
            rng.standard_normal((BKV, Sk, hd)).astype(np.float32))


def _t(*arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _j(*arrays, dtype=jnp.float32):
    return [jnp.asarray(a, dtype) for a in arrays]


@pytest.mark.parametrize("case", SWEEP)
def test_flash_attention_matches_pallas_and_oracle(case):
    BH, BKV, S, hd, bq, bkv, causal, window, softcap = case
    group = BH // BKV
    q, k, v = _qkv(BH, BKV, S, hd, seed=1)
    kw = dict(causal=causal, window=window, softcap=softcap)
    before = tk.launches
    got = tk.flash_attention(*_t(q, k, v), block_q=bq, block_kv=bkv,
                             group=group, **kw).numpy()
    assert tk.launches == before       # the plain version launches nothing
    pallas = np.asarray(fk.flash_attention(*_j(q, k, v), block_q=bq,
                                           block_kv=bkv, group=group,
                                           interpret=True, **kw))
    oracle = np.asarray(fref.flash_attention(*_j(q, k, v), group=group,
                                             **kw))
    np.testing.assert_allclose(got, pallas, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got, oracle, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("case", SWEEP)
def test_flash_attention_bf16_matches_pallas(case):
    BH, BKV, S, hd, bq, bkv, causal, window, softcap = case
    q, k, v = _qkv(BH, BKV, S, hd, seed=2)
    kw = dict(causal=causal, window=window, softcap=softcap,
              group=BH // BKV)
    got = tk.flash_attention(*_t(q, k, v, dtype=torch.bfloat16),
                             block_q=bq, block_kv=bkv, **kw)
    assert got.dtype == torch.bfloat16
    pallas = fk.flash_attention(*_j(q, k, v, dtype=jnp.bfloat16),
                                block_q=bq, block_kv=bkv, interpret=True,
                                **kw)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(pallas, np.float32),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 2e-2)])
def test_flash_attention_dtypes(dtype, atol):
    q, k, v = _qkv(2, 2, 64, 32, seed=3)
    got = tk.flash_attention(*_t(q, k, v, dtype=dtype), causal=True,
                             block_q=16, block_kv=16)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = fref.flash_attention(*_j(q, k, v, dtype=jdt), causal=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=atol)


@pytest.mark.parametrize("Sq,Sk,causal,window", [
    (40, 24, True, None), (40, 24, True, 5), (24, 40, False, 7),
    (16, 16, True, 0)])
def test_flash_attention_unequal_lengths_and_unseen_rows(Sq, Sk, causal,
                                                        window):
    """Positions run from 0 on both axes; a row that sees no key averages
    every value, as the reference's finite NEG_INF makes it."""
    q, k, v = _qkv(2, 1, Sq, 16, seed=4, Sk=Sk)
    kw = dict(causal=causal, window=window, group=2)
    got = tk.flash_attention(*_t(q, k, v), block_q=8, block_kv=8,
                             **kw).numpy()
    pallas = np.asarray(fk.flash_attention(*_j(q, k, v), block_q=8,
                                           block_kv=8, interpret=True, **kw))
    np.testing.assert_allclose(got, pallas, atol=2e-5, rtol=2e-5)


def test_flash_attention_grouped_layout_matches_model_layer():
    B, S, Hk, G, hd = 2, 32, 2, 3, 16
    rng = np.random.default_rng(5)
    qg = rng.standard_normal((B, S, Hk, G, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, Hk, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, Hk, hd)).astype(np.float32)
    got = tops.flash_attention_grouped(*_t(qg, k, v), causal=True,
                                       block_q=8, block_kv=8).numpy()
    tpos = torch.arange(S)
    port_full = t_attend_full(*_t(qg, k, v), q_pos=tpos, k_pos=tpos,
                              causal=True, window=None,
                              softcap=None).numpy()
    jpos = jnp.arange(S)
    jax_full = np.asarray(j_attend_full(*_j(qg, k, v), q_pos=jpos,
                                        k_pos=jpos, causal=True,
                                        window=None, softcap=None))
    jax_grouped = np.asarray(fops.flash_attention_grouped(
        *_j(qg, k, v), causal=True, block_q=8, block_kv=8))
    assert got.shape == (B, S, Hk, G, hd)
    for want in (port_full, jax_full, jax_grouped):
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("S,block_q,block_kv", [(48, 32, 16), (48, 16, 32),
                                                (40, 16, 16)])
def test_block_contract_raises_where_the_reference_asserts(S, block_q,
                                                           block_kv):
    q, k, v = _qkv(2, 2, S, 16, seed=6)
    with pytest.raises(AssertionError):
        fk.flash_attention(*_j(q, k, v), block_q=block_q, block_kv=block_kv,
                           interpret=True)
    with pytest.raises(ValueError, match="blocks must divide"):
        tk.flash_attention(*_t(q, k, v), block_q=block_q, block_kv=block_kv)


def test_blocks_are_clipped_to_the_sequence():
    q, k, v = _qkv(2, 2, 24, 16, seed=7)
    got = tk.flash_attention(*_t(q, k, v), block_q=512, block_kv=1024)
    want = fk.flash_attention(*_j(q, k, v), block_q=512, block_kv=1024,
                              interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("bad,match", [
    (dict(dtype=torch.float16), "float32 or bfloat16"),
    (dict(hd=12), "multiple of 8"),
    (dict(hd=264), "multiple of 8"),
    (dict(group=3), "BH == BKV"),
])
def test_flash_attention_rejects_what_the_kernel_does_not_take(bad, match):
    hd, group = bad.get("hd", 16), bad.get("group", 1)
    q, k, v = _t(*_qkv(2, 2, 16, hd, seed=8),
                 dtype=bad.get("dtype", torch.float32))
    with pytest.raises((TypeError, ValueError), match=match):
        tk.flash_attention(q, k, v, group=group)


def test_flash_attention_rejects_bad_window_and_softcap():
    q, k, v = _t(*_qkv(2, 2, 16, 16, seed=9))
    with pytest.raises(ValueError, match="window"):
        tk.flash_attention(q, k, v, window=-1)
    with pytest.raises(ValueError, match="softcap"):
        tk.flash_attention(q, k, v, softcap=0.0)


@pytest.mark.parametrize("Sq,Sk,causal,window", [
    (64, 64, True, None), (64, 64, True, 9), (40, 24, True, None),
    (24, 40, False, 7), (16, 16, False, None)])
def test_flops_count_the_visible_pairs(Sq, Sk, causal, window):
    qp = np.arange(Sq)[:, None]
    kp = np.arange(Sk)[None, :]
    ok = (kp <= qp) if causal else np.ones((Sq, Sk), bool)
    if window is not None:
        ok &= qp - kp < window
    assert tref.flops(3, Sq, Sk, 16, causal=causal, window=window) == \
        4.0 * 3 * 16 * ok.sum()


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32's 10-bit mantissa (to nearest, ties to even)."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0xFFF + ((b >> 13) & 1)) & ~0x1FFF).view(torch.float32)


def test_tf32_products_leave_the_float32_tolerance():
    """A witness for the card's float32 checks: a kernel that fed TF32
    products (q, k, p and v rounded to 10 mantissa bits, sums in float32)
    would leave FLASH_TOL["float32"], against which chip_smoke.py and the
    card tests hold the float32 kernel; the plain version stays within it
    of the JAX oracle."""
    q, k, v = _t(*_qkv(2, 2, 64, 128, seed=10))
    tol = FLASH_TOL["float32"]
    want = tref.flash_attention(q, k, v, causal=True)
    oracle = np.asarray(fref.flash_attention(*_j(*(t.numpy() for t in (
        q, k, v))), causal=True))
    np.testing.assert_allclose(want.numpy(), oracle, atol=tol, rtol=tol)
    s = torch.einsum("bqd,bkd->bqk", _tf32(q), _tf32(k)) * 128 ** -0.5
    pos = torch.arange(64)
    s = s.masked_fill(pos[None, :] > pos[:, None], tref.NEG_INF)
    tf32 = torch.einsum("bqk,bkd->bqd", _tf32(torch.softmax(s, dim=-1)),
                        _tf32(v))
    assert _tf32(torch.tensor([1.0 + 3 * 2.0 ** -11])).item() == \
        1.0 + 2.0 ** -9
    assert not torch.allclose(tf32, want, atol=tol, rtol=tol)

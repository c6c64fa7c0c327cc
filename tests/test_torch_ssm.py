"""The port's Mamba-2 block against the JAX package's.

Seeded numpy inputs, or the JAX package's weights carried across with
``from_numpy``, go to both packages in float32 on the CPU.  Tolerances:
the chunked SSD scan 1e-4 against the JAX function and against the
recurrent oracle (the JAX package's own bound,
``tests/test_model_correctness.py``), the causal convolution 1e-6, the
block's prefill and decode 1e-5.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced_config as j_reduced
from repro.models import ssm as jssm
from repro.models.params import init_params as j_init_params
from repro_torch.configs import get_config, reduced_config
from repro_torch.models import ssm as tssm
from repro_torch.models.params import from_numpy

SSD_TOL = 1e-4
CONV_TOL = 1e-6
BLOCK_TOL = 1e-5


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol)


def ssd_inputs(B, L, H, P, N, G, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, L, H)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(H) * 0.5).astype(np.float32)
    Bm = rng.standard_normal((B, L, G, N)).astype(np.float32)
    Cm = rng.standard_normal((B, L, G, N)).astype(np.float32)
    return x, dt, A, Bm, Cm


def both(arrays):
    return ([torch.from_numpy(a) for a in arrays],
            [jnp.asarray(a) for a in arrays])


@pytest.mark.parametrize("chunk", [4, 8, 32])
@pytest.mark.parametrize("G", [1, 2])
def test_ssd_chunked_matches_the_reference_and_the_oracle(chunk, G):
    t, j = both(ssd_inputs(2, 32, 4, 8, 16, G, seed=chunk + G))
    y, s = tssm.ssd_chunked(*t, chunk=chunk, return_state=True)
    jy, js = jssm.ssd_chunked(*j, chunk=chunk, return_state=True)
    close(y, jy, SSD_TOL)
    close(s, js, SSD_TOL)
    ry, rs = tssm.ssd_reference(*t)
    close(y, ry, SSD_TOL)
    close(s, rs, SSD_TOL)
    jry, jrs = jssm.ssd_reference(*j)
    close(ry, jry, SSD_TOL)
    close(rs, jrs, SSD_TOL)


def test_ssd_pads_a_ragged_length_to_whole_chunks():
    t, j = both(ssd_inputs(1, 30, 4, 8, 16, 1, seed=7))
    y, s = tssm.ssd_chunked(*t, chunk=8, return_state=True)
    jy, js = jssm.ssd_chunked(*j, chunk=8, return_state=True)
    assert tuple(y.shape) == (1, 30, 4, 8)
    close(y, jy, SSD_TOL)
    close(s, js, SSD_TOL)
    close(y, tssm.ssd_reference(*t)[0], SSD_TOL)


def test_ssd_initial_state_continuation():
    """Running [0:L1] then [L1:L] with carried state == running [0:L]."""
    (x, dt, A, Bm, Cm), (jx, jdt, jA, jBm, jCm) = both(
        ssd_inputs(1, 32, 2, 4, 8, 1, seed=3))
    L1 = 16
    full = tssm.ssd_chunked(x, dt, A, Bm, Cm, chunk=8)
    y1, s1 = tssm.ssd_chunked(x[:, :L1], dt[:, :L1], A, Bm[:, :L1],
                              Cm[:, :L1], chunk=8, return_state=True)
    y2 = tssm.ssd_chunked(x[:, L1:], dt[:, L1:], A, Bm[:, L1:], Cm[:, L1:],
                          chunk=8, initial_state=s1)
    close(torch.cat([y1, y2], 1), full, SSD_TOL)
    jy2 = jssm.ssd_chunked(jx[:, L1:], jdt[:, L1:], jA, jBm[:, L1:],
                           jCm[:, L1:], chunk=8,
                           initial_state=jnp.asarray(s1.numpy()))
    close(y2, jy2, SSD_TOL)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches(with_state):
    rng = np.random.default_rng(11)
    xBC = rng.standard_normal((2, 5, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    st = rng.standard_normal((2, 3, 12)).astype(np.float32) \
        if with_state else None
    t_args = [torch.from_numpy(a) for a in (xBC, w, b)]
    j_args = [jnp.asarray(a) for a in (xBC, w, b)]
    out, new = tssm._causal_conv(
        *t_args, state=None if st is None else torch.from_numpy(st))
    jout, jnew = jssm._causal_conv(
        *j_args, state=None if st is None else jnp.asarray(st))
    close(out, jout, CONV_TOL)
    close(new, jnew, CONV_TOL)
    assert tuple(new.shape) == (2, 3, 12)


def _mamba_weights(seed=0):
    cfg = reduced_config(get_config("mamba2-780m"))
    j_cfg = j_reduced(j_get_config("mamba2-780m"))
    jp = j_init_params(jssm.def_mamba2(j_cfg), jax.random.key(seed))
    # A_log, D are ones and the biases zeros at init: move them off it
    rng = np.random.default_rng(seed)
    jp = {k: np.asarray(v) + (0.3 * rng.standard_normal(v.shape).astype(
        np.float32) if k in ("A_log", "dt_bias", "D", "norm", "conv_b")
        else 0) for k, v in jp.items()}
    return cfg, j_cfg, {k: jnp.asarray(v) for k, v in jp.items()}, \
        from_numpy(jp, torch.float32, "cpu")


def test_mamba2_block_prefill_and_decode_match():
    cfg, j_cfg, jp, tp = _mamba_weights()
    B, S = 2, 13                     # not a multiple of the chunk (8)
    x = np.random.default_rng(12).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    # no cache: the output only
    out, nc = tssm.mamba2_block(tp, torch.from_numpy(x), cfg=cfg)
    j_block = jax.jit(functools.partial(jssm.mamba2_block, cfg=j_cfg),
                      static_argnames="decode")
    jout, jnc = j_block(jp, jnp.asarray(x))
    assert nc is None and jnc is None
    close(out, jout, BLOCK_TOL)
    # prefill fills a cache, then three decode steps
    tc = tssm.init_mamba_cache(cfg, B, torch.float32, device="cpu")
    jc = jssm.init_mamba_cache(j_cfg, B)
    for k in ("conv", "ssm"):
        assert tuple(tc[k].shape) == jc[k].shape
        assert tc[k].dtype == torch.float32
    out, tc = tssm.mamba2_block(tp, torch.from_numpy(x), cfg=cfg, cache=tc)
    jout, jc = j_block(jp, jnp.asarray(x), cache=jc)
    close(out, jout, BLOCK_TOL)
    for k in ("conv", "ssm"):
        close(tc[k], jc[k], BLOCK_TOL)
    for step in range(3):
        x1 = np.random.default_rng(20 + step).standard_normal(
            (B, 1, cfg.d_model)).astype(np.float32)
        out, tc = tssm.mamba2_block(tp, torch.from_numpy(x1), cfg=cfg,
                                    cache=tc, decode=True)
        jout, jc = j_block(jp, jnp.asarray(x1), cache=jc, decode=True)
        close(out, jout, BLOCK_TOL)
        for k in ("conv", "ssm"):
            close(tc[k], jc[k], BLOCK_TOL)


def test_mamba2_decode_continues_its_prefill():
    """Prefill of S then a decode step equals the prefill of S+1 at its
    last position (the recurrence and the chunked scan agree)."""
    cfg, _, _, tp = _mamba_weights(seed=1)
    B, S = 2, 9
    x = torch.from_numpy(np.random.default_rng(13).standard_normal(
        (B, S + 1, cfg.d_model)).astype(np.float32))
    whole, _ = tssm.mamba2_block(tp, x, cfg=cfg)
    cache = tssm.init_mamba_cache(cfg, B, device="cpu")
    _, cache = tssm.mamba2_block(tp, x[:, :S], cfg=cfg, cache=cache)
    last, _ = tssm.mamba2_block(tp, x[:, S:], cfg=cfg, cache=cache,
                                decode=True)
    close(last[:, 0], whole[:, S], BLOCK_TOL)


def test_decode_takes_one_token_and_a_cache():
    cfg, _, _, tp = _mamba_weights()
    x = torch.zeros((1, 2, cfg.d_model))
    with pytest.raises(ValueError, match="decode"):
        tssm.mamba2_block(tp, x, cfg=cfg, decode=True)


def test_ssd_gradients_stay_finite_where_the_decay_overflows():
    """Step sizes 7x the usual put exp(cum_i - cum_j) above float32's range
    in the chunk's upper triangle; masked before the exp, the chunked scan's
    gradients are finite and equal the recurrent oracle's."""
    x, dt, A, Bm, Cm = ssd_inputs(1, 16, 2, 4, 8, 1, seed=5)
    dt = dt * 7.0
    cum = np.cumsum((dt * A).reshape(1, 2, 8, 2), axis=2)
    assert (cum.max(axis=2) - cum.min(axis=2)).max() > np.log(
        np.finfo(np.float32).max)
    grads = {}
    for name, fn in (("chunked", lambda *a: tssm.ssd_chunked(*a, chunk=8)),
                     ("oracle", lambda *a: tssm.ssd_reference(*a)[0])):
        leaves = [torch.from_numpy(a.copy()).requires_grad_()
                  for a in (x, dt, A, Bm, Cm)]
        fn(*leaves).square().sum().backward()
        grads[name] = [t.grad for t in leaves]
    assert all(torch.isfinite(g).all() for g in grads["chunked"])
    for got, want in zip(grads["chunked"], grads["oracle"]):
        # relative to each gradient's largest: its entries span 1e-2..1e3
        assert (got - want).abs().max() <= SSD_TOL * want.abs().max()

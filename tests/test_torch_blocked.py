"""The port's blocked attention against the JAX package's.

``attend_blocked`` (the flash path, ``BlockedFlash``, and the banded path,
``BandedAttention``) is held to the JAX package's ``attend_blocked`` on
seeded numpy inputs in float32 on the CPU: the forward within 2e-5, the
gradients dq/dk/dv (``torch.autograd.grad`` against ``jax.vjp``, one
seeded cotangent) within 3e-5, the JAX package's own tolerances
(``tests/test_model_correctness.py``).  The sweeps are that file's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import layers as jl
from repro.models import transformer as jtr
from repro_torch.configs import get_config
from repro_torch.models import layers as tl
from repro_torch.models import transformer as ttr

FWD_TOL = 2e-5
GRAD_TOL = 3e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """This module's CPU work is tiny: run it on one intra-op thread, so
    that beside the suite's other workers it does not oversubscribe the
    host."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _inputs(B, S, Hk, G, hd, seed, Sk=None):
    rng = np.random.default_rng(seed)
    Sk = S if Sk is None else Sk
    f = np.float32
    return (rng.standard_normal((B, S, Hk, G, hd)).astype(f),
            rng.standard_normal((B, Sk, Hk, hd)).astype(f),
            rng.standard_normal((B, Sk, Hk, hd)).astype(f),
            rng.standard_normal((B, S, Hk, G, hd)).astype(f))  # cotangent


def _jax(q, k, v, w, **kw):
    def f(q, k, v):
        return jl.attend_blocked(q, k, v, **kw)
    out, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(w))]


def _torch(q, k, v, w, **kw):
    qkv = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = tl.attend_blocked(*qkv, **kw)
    grads = torch.autograd.grad(out, qkv, torch.from_numpy(w))
    return out.detach().numpy(), [g.numpy() for g in grads]


def _close(got, want, tol):
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


def _match(q, k, v, w, **kw):
    out_t, g_t = _torch(q, k, v, w, **kw)
    out_j, g_j = _jax(q, k, v, w, **kw)
    _close(out_t, out_j, FWD_TOL)
    for a, b in zip(g_t, g_j):
        _close(a, b, GRAD_TOL)
    return out_t, g_t


@pytest.mark.parametrize("bq,bkv", [(16, 16), (64, 8), (8, 32)])
@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("softcap", [None, 20.0])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_path_matches_reference(causal, softcap, window, bq, bkv):
    q, k, v, w = _inputs(2, 64, 2, 3, 8, seed=0)
    _match(q, k, v, w, causal=causal, window=window, softcap=softcap,
           block_q=bq, block_kv=bkv)


@pytest.mark.parametrize("softcap", [None, 15.0])
@pytest.mark.parametrize("window", [None, 9])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_gradients_match_reference_and_dense(causal, window, softcap):
    q, k, v, w = _inputs(2, 32, 2, 2, 8, seed=7)
    kw = dict(causal=causal, window=window, softcap=softcap)
    _, g_blocked = _match(q, k, v, w, block_q=8, block_kv=16, **kw)
    qkv = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    pos = torch.arange(32)
    dense = tl.attend_full(*qkv, q_pos=pos, k_pos=pos, **kw)
    for a, b in zip(g_blocked, torch.autograd.grad(dense, qkv,
                                                   torch.from_numpy(w))):
        _close(a, b.numpy(), GRAD_TOL)


@pytest.mark.parametrize("flag", [True, False])
def test_local_flag_tensor_matches_reference(flag):
    q, k, v, w = _inputs(1, 16, 1, 2, 4, seed=8)
    out_t, g_t = _torch(q, k, v, w, causal=True, window=5, softcap=None,
                        local_flag=torch.tensor(flag), block_q=8, block_kv=8)
    out_j, g_j = _jax(q, k, v, w, causal=True, window=5, softcap=None,
                      local_flag=jnp.bool_(flag), block_q=8, block_kv=8)
    _close(out_t, out_j, FWD_TOL)
    for a, b in zip(g_t, g_j):
        _close(a, b, GRAD_TOL)
    # the flag picks the window or none, as a static window would
    static, _ = _torch(q, k, v, w, causal=True, window=5 if flag else None,
                       softcap=None, block_q=8, block_kv=8)
    _close(out_t, static, 1e-6)


@pytest.mark.parametrize("window,bq,bkv", [(7, 8, 8), (16, 8, 16),
                                           (9, 16, 8)])
def test_banded_path_matches_reference(window, bq, bkv):
    q, k, v, w = _inputs(2, 64, 2, 2, 8, seed=11)
    qkv = [torch.from_numpy(a) for a in (q, k, v)]
    out = tl.attend_blocked(*[t.requires_grad_() for t in qkv], causal=True,
                            window=window, softcap=None, block_q=bq,
                            block_kv=bkv)
    assert type(out.grad_fn).__name__ == "BandedAttentionBackward"
    _match(q, k, v, w, causal=True, window=window, softcap=None,
           block_q=bq, block_kv=bkv)


def test_banded_softcap_and_a_band_as_long_as_the_keys():
    q, k, v, w = _inputs(1, 64, 2, 2, 8, seed=12)
    _match(q, k, v, w, causal=True, window=9, softcap=20.0, block_q=16,
           block_kv=8)
    # window + block_q - 1 reaches every key: the flash path, as in JAX
    q, k, v, w = _inputs(1, 32, 1, 2, 8, seed=13)
    out = tl.attend_blocked(*(torch.from_numpy(a).requires_grad_()
                              for a in (q, k, v)), causal=True, window=20,
                            softcap=None, block_q=16, block_kv=16)
    assert type(out.grad_fn).__name__ == "BlockedFlashBackward"
    _match(q, k, v, w, causal=True, window=20, softcap=None, block_q=16,
           block_kv=16)


def test_kv_valid_len_falls_back_to_dense_attention():
    q, k, v, _ = _inputs(2, 16, 1, 2, 8, seed=14)
    valid = np.array([9, 16], np.int32)
    got = tl.attend_blocked(*(torch.from_numpy(a) for a in (q, k, v)),
                            causal=True, window=None, softcap=None,
                            block_q=8, block_kv=8,
                            kv_valid_len=torch.from_numpy(valid)[:, None,
                                                                 None])
    want = jl.attend_blocked(*(jnp.asarray(a) for a in (q, k, v)),
                             causal=True, window=None, softcap=None,
                             block_q=8, block_kv=8,
                             kv_valid_len=jnp.asarray(valid)[:, None, None])
    _close(got.numpy(), np.asarray(want), FWD_TOL)


def test_blocks_must_divide_the_sequence():
    q, k, v, _ = _inputs(1, 24, 1, 1, 4, seed=15)
    with pytest.raises(ValueError, match="whole blocks"):
        tl.attend_blocked(*(torch.from_numpy(a) for a in (q, k, v)),
                          causal=True, window=None, softcap=None, block_q=16,
                          block_kv=8)


@pytest.mark.parametrize("window", [None, 16])
def test_backward_saves_only_inputs_output_and_lse(window):
    """O(S·hd) saved for the backward: q, k, v, out and L (and the window
    scalar), never the per-block f32 accumulators."""
    B, S, Hk, G, hd = 1, 64, 2, 2, 8
    q, k, v, _ = _inputs(B, S, Hk, G, hd, seed=16)
    out = tl.attend_blocked(*(torch.from_numpy(a).requires_grad_()
                              for a in (q, k, v)), causal=True,
                            window=window, softcap=None, block_q=8,
                            block_kv=8)
    saved = sum(t.numel() for t in out.grad_fn.saved_tensors)
    lse = B * Hk * G * S
    assert saved in (2 * q.size + k.size + v.size + lse,
                     2 * q.size + k.size + v.size + lse + 1)


def test_bf16_forward_matches_reference():
    q, k, v, _ = _inputs(2, 64, 2, 2, 16, seed=17)
    for window in (None, 9):
        kw = dict(causal=True, window=window, softcap=None, block_q=16,
                  block_kv=16)
        got = tl.attend_blocked(*(torch.from_numpy(a).to(torch.bfloat16)
                                  for a in (q, k, v)), **kw)
        want = jl.attend_blocked(*(jnp.asarray(a, jnp.bfloat16)
                                   for a in (q, k, v)), **kw)
        assert got.dtype == torch.bfloat16
        _close(got.float().numpy(), np.asarray(want, np.float32), 2e-2)


# ---------------------------------------------------------------------------
# the cache and layer helpers the blocked path's families share
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen2-7b", "gemma2-2b", "hymba-1.5b"])
def test_uses_uniform_global_is_the_references(arch):
    assert ttr.uses_uniform_global(get_config(arch)) == \
        jtr.uses_uniform_global(j_get_config(arch))


def test_init_attn_cache_and_stacked_layers_are_the_references():
    cfg, jcfg = get_config("qwen2-7b"), j_get_config("qwen2-7b")
    got = ttr.init_attn_cache(cfg, 2, 8, torch.bfloat16, device="cpu")
    want = jtr.init_attn_cache(jcfg, 2, 8, jnp.bfloat16)
    for key in ("k", "v", "pos"):
        assert tuple(got[key].shape) == want[key].shape
        assert str(got[key].dtype).split(".")[-1] == str(want[key].dtype)
    stacked = ttr._stack_layers(got, 3)
    assert tuple(stacked["k"].shape) == (3, 2, 8, 4, 128)
    stacked["k"][0].fill_(1)           # layers do not share memory
    assert stacked["k"][1].abs().sum() == 0
    assert got["k"].abs().sum() == 0

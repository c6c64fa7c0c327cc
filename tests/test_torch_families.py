"""The port's other model families against the JAX package's: mixture of
experts, the vision frontend, Mamba-2, Hymba and the encoder-decoder.

Weights are the JAX package's (``model.init(jax.random.key(0))``), carried
across by ``from_numpy``; inputs are seeded numpy arrays given to both.
Everything runs in float32 on the CPU at ``reduced_config`` size.  The
port's ``"cuda"`` attention runs its kernel's plain version here, held to
the JAX package's ``"pallas"`` (interpret mode); ``"full"`` to ``"full"``.
The encoder-decoder's ``"cuda"`` is held to the JAX package's ``"full"``:
the JAX package's ``"pallas"`` masks the encoder causally, which the port
does not copy (pinned below).  Tolerances: the MoE block 1e-5, its routing
(expert indices, keep mask, the port's drop fraction) exact, its two
losses 1e-6 (sums of router probabilities in each framework's order); the
Hymba and encoder-decoder blocks 1e-5, with weights of fan-in d; whole
models (hidden, logits, aux, caches) 1e-4 of the larger of 1 and the
reference's largest magnitude: the stacked weights' std of 1/sqrt(2)
saturates attention, and the encoder-decoder's logits lie 5e-4 from a
float64 forward in both packages, 1.9e-4 apart (running this file prints
those gaps); greedy tokens identical; a train step the bounds of
``tests/test_torch_train.py``, Mamba-2's against the JAX package's step
with its recurrent oracle in place of its chunked scan, whose gradients
are NaN (pinned below).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced_config as j_reduced
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import MoEConfig as JMoEConfig
from repro.configs.run import RunConfig as JRun
from repro.models import encdec as jencdec
from repro.models import frontends as jfront
from repro.models import hybrid as jhybrid
from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro.models.model_zoo import build_model as j_build
from repro.models.params import init_params as j_init_params
from repro.optim import adamw as jadamw
from repro.serve.engine import Engine as JEngine, Request as JRequest
from repro.serve.step import make_decode_step as j_decode_step
from repro.serve.step import make_prefill_step as j_prefill_step
from repro.train.step import init_train_state as j_init_state
from repro.train.step import make_train_step as j_make_step
from repro_torch.configs import get_config, list_archs, reduced_config
from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.configs.run import SERVE_RUN, RunConfig
from repro_torch.models import encdec as tencdec
from repro_torch.models import frontends as tfront
from repro_torch.models import hybrid as thybrid
from repro_torch.models import moe as tmoe
from repro_torch.models.model_zoo import build_model
from repro_torch.models.params import (from_numpy, map_tensors,
                                       train_state_from_numpy)
from repro_torch.optim import adamw
from repro_torch.serve.engine import Engine, Request
from repro_torch.serve.step import make_decode_step, make_prefill_step
from repro_torch.train import step as step_mod
from repro_torch.train.step import make_train_step

TOL = 1e-4
BLOCK_TOL = 1e-5
SMALL_TOL = 1e-6        # the new state from AdamW on the port's grads
STEP_TOL = 1e-5         # loss and the metrics of a train step
GRAD_NORM_TOL = 1e-4    # relative
MOMENT_TOL = 1e-3       # of a leaf's largest
AUX_TOL = 1e-6          # MoE losses: a float32 sum of router probabilities
F32 = dict(param_dtype="float32", compute_dtype="float32",
           cache_dtype="float32")
ARCHS = ["llama4-scout-17b-a16e", "moonshot-v1-16b-a3b", "qwen2-vl-2b",
         "mamba2-780m", "hymba-1.5b", "seamless-m4t-medium"]
IMPLS = ["full", "cuda"]
# (arch, port impl); Mamba-2 has no attention, so one impl is all of it
CASES = [(a, i) for a in ARCHS for i in IMPLS
         if (a, i) != ("mamba2-780m", "cuda")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU work: one intra-op thread, so that beside the suite's other
    workers it does not oversubscribe the host."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def j_impl(arch, impl):
    """The JAX package's counterpart of the port's ``impl`` for ``arch``."""
    if impl == "full" or arch == "seamless-m4t-medium":
        return "full"
    return "pallas"


_MODELS = {}


def models(arch, impl="full"):
    """(JAX model, JAX params, port model, port params), cached."""
    key = (arch, impl)
    if key not in _MODELS:
        jm = j_build(j_reduced(j_get_config(arch)),
                     JRun(attn_impl=j_impl(arch, impl), remat="none", **F32))
        tm = build_model(reduced_config(get_config(arch)),
                         RunConfig(attn_impl=impl, **F32))
        jp = jm.init(jax.random.key(0))
        tp = from_numpy(jax.tree.map(np.asarray, jp), torch.float32, "cpu")
        _MODELS[key] = (jm, jp, tm, tp)
    return _MODELS[key]


def jit(fn, **static):
    """``fn`` with ``static`` keywords bound, compiled by XLA whole: op by
    op, the JAX package compiles each primitive on the CPU at ~40 ms."""
    return jax.jit(functools.partial(fn, **static))


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol)


def scaled_gap(got, want) -> float:
    """max |got - want| over max(1, max |want|)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max(initial=0.0)
                 / max(1.0, np.abs(want).max(initial=0.0)))


def near(got, want, tol=TOL):
    """Within ``tol`` of the larger of 1 and the reference's largest
    magnitude: a whole model's float32 floor is relative to its scale."""
    assert scaled_gap(got, want) <= tol


def same_trees(got, want, tol=TOL, check=near):
    flat_t = dict(_flat(got))
    flat_j = dict(_flat(want))
    assert flat_t.keys() == flat_j.keys()
    for k in flat_t:
        assert flat_t[k].shape == flat_j[k].shape, k
        check(flat_t[k], flat_j[k], tol)


def _flat(tree, prefix=""):
    if isinstance(tree, (dict, tuple, list)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        for k, v in items:
            yield from _flat(v, f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree.detach().cpu().numpy()
                                 if isinstance(tree, torch.Tensor) else tree)


def batches(arch, B, S, seed):
    """(port batch, JAX batch) of seeded numpy inputs for ``arch``'s
    prefill or forward: tokens; embeds with M-RoPE positions (vlm); source
    frames and target tokens (encdec)."""
    cfg = reduced_config(get_config(arch))
    rng = np.random.default_rng(seed)
    if cfg.family == "encdec":
        arrays = {"src_embeds": (0.02 * rng.standard_normal(
            (B, S, cfg.d_model))).astype(np.float32),
            "tgt_tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
                np.int32)}
    elif cfg.frontend == "vision_patches":
        arrays = {"embeds": (0.02 * rng.standard_normal(
            (B, S, cfg.d_model))).astype(np.float32),
            "positions": tfront.mrope_positions(B, S, grid=(2, 2, 2),
                                                device="cpu").numpy()}
    else:
        arrays = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
            np.int32)}
    return ({k: torch.from_numpy(v.copy()) for k, v in arrays.items()},
            {k: jnp.asarray(v) for k, v in arrays.items()})


# ---------------------------------------------------------------------------
# the zoo
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", list_archs())
def test_build_model_builds_every_architecture(arch):
    tm = build_model(get_config(arch), SERVE_RUN)
    jm = j_build(j_get_config(arch), JRun(param_dtype="bfloat16"))
    assert tm.num_params() == jm.num_params()
    small_t = build_model(reduced_config(get_config(arch)), SERVE_RUN)
    p = small_t.init(torch.Generator().manual_seed(0), device="cpu")
    want = jax.eval_shape(j_build(j_reduced(j_get_config(arch)),
                                  JRun(param_dtype="bfloat16")).init,
                          jax.random.key(0))
    same_shapes = jax.tree.map(lambda a: a.shape, want)
    assert map_tensors(p, lambda t: tuple(t.shape)) == same_shapes


@pytest.mark.parametrize("arch", ARCHS)
def test_from_numpy_carries_every_familys_tree(arch):
    jm, jp, tm, tp = models(arch)
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    n = 0
    for path, leaf in flat_j:
        t = tp
        for p in path:
            t = t[p.key]
        assert np.array_equal(t.numpy(), np.asarray(leaf))
        n += 1
    assert n == len(list(_flat(tp)))


@pytest.mark.parametrize("arch,impl", CASES)
def test_forward_matches(arch, impl):
    jm, jp, tm, tp = models(arch, impl)
    tb, jb = batches(arch, 2, 16, seed=1)
    j_hidden, j_cache, j_aux = jm.forward(jp, jb)
    t_hidden, t_cache, t_aux = tm.forward(tp, tb)
    assert t_cache is None and j_cache is None
    near(t_hidden, j_hidden)
    near(tm.logits(tp, t_hidden), jm.logits(jp, j_hidden))
    assert t_aux.keys() == j_aux.keys()
    for k in t_aux:
        near(t_aux[k], j_aux[k])
    if tm.cfg.family == "moe":
        assert set(t_aux) == {"moe_load_balance", "moe_router_z",
                              "moe_drop_fraction"}


@pytest.mark.parametrize("arch,impl", CASES)
def test_prefill_and_three_decode_steps_match(arch, impl):
    jm, jp, tm, tp = models(arch, impl)
    B, S, T = 2, 12, 16
    tb, jb = batches(arch, B, S, seed=2)
    src = dict(src_len=S) if tm.cfg.family == "encdec" else {}
    j_tok, j_cache = jax.jit(j_prefill_step(jm, T, **src))(jp, jb)
    t_tok, t_cache = make_prefill_step(tm, T, **src)(tp, tb)
    assert t_tok.dtype == torch.int32
    assert np.array_equal(t_tok.numpy(), np.asarray(j_tok))
    same_trees(t_cache, j_cache)
    j_decode = jax.jit(j_decode_step(jm))
    for _ in range(3):
        j_tok, j_cache = j_decode(jp, j_tok, j_cache)
        t_tok, t_cache = make_decode_step(tm)(tp, t_tok, t_cache)
        assert np.array_equal(t_tok.numpy(), np.asarray(j_tok))
        same_trees(t_cache, j_cache)


@pytest.mark.parametrize("arch,impl", [
    ("llama4-scout-17b-a16e", "cuda"), ("moonshot-v1-16b-a3b", "full"),
    ("mamba2-780m", "full"), ("hymba-1.5b", "cuda")])
def test_engine_serve_greedy_tokens_are_the_references(arch, impl):
    jm, jp, tm, tp = models(arch, impl)
    rng = np.random.default_rng(7)
    spec = [(list(rng.integers(0, 256, n)), m)
            for n, m in ((5, 6), (11, 4), (3, 8), (7, 5), (9, 3))]
    j_reqs = JEngine(jm, jp, batch_slots=4, max_len=32).serve(
        [JRequest(prompt=p, max_new_tokens=m) for p, m in spec])
    t_reqs = Engine(tm, tp, batch_slots=4, max_len=32, device="cpu").serve(
        [Request(prompt=p, max_new_tokens=m) for p, m in spec])
    assert [r.out_tokens for r in t_reqs] == [r.out_tokens for r in j_reqs]
    assert [len(r.out_tokens) for r in t_reqs] == [m for _, m in spec]


def test_reference_pallas_masks_the_encoder_the_port_does_not():
    """The JAX package's ``"pallas"`` attention passes ``causal=True`` to
    its kernel whatever the caller asks, so its encoder is causal there and
    unmasked under ``"full"``.  The port's ``"cuda"`` honours
    ``causal=False``: it is the JAX package's ``"full"``, not its
    ``"pallas"``."""
    arch = "seamless-m4t-medium"
    jm, jp, tm, tp = models(arch, "cuda")
    tb, jb = batches(arch, 2, 16, seed=1)
    jpal = j_build(jm.cfg, JRun(attn_impl="pallas", remat="none", **F32))
    enc = {}
    for name, m in (("full", jm), ("pallas", jpal)):
        enc[name] = np.asarray(jit(jencdec.encode, cfg=m.cfg, run=m.run)(
            jp, jb["src_embeds"]))
    t_enc = tencdec.encode(tp, tb["src_embeds"], cfg=tm.cfg, run=tm.run)
    near(t_enc, enc["full"])
    assert np.abs(enc["pallas"] - enc["full"]).max() > 1e-2
    assert np.abs(t_enc.numpy() - enc["pallas"]).max() > 1e-2


# ---------------------------------------------------------------------------
# the forward_stack repair: a decode step from a cache with no "attn"
# ---------------------------------------------------------------------------

def test_mamba2_decode_from_a_cache_without_attn_matches():
    jm, jp, tm, tp = models("mamba2-780m")
    B = 2
    t_cache = tm.init_cache(B, 8, device="cpu")
    j_cache = jm.init_cache(B, 8)
    assert set(t_cache) == set(j_cache) == {"ssm"}
    toks = np.array([[3], [250]], np.int32)
    j_hidden, j_cache, _ = jit(jm.forward, decode=True)(
        jp, {"tokens": jnp.asarray(toks)}, cache=j_cache)
    t_hidden, t_cache, _ = tm.forward(tp, {"tokens": torch.from_numpy(toks)},
                                      cache=t_cache, decode=True)
    near(t_hidden, j_hidden)
    same_trees(t_cache, j_cache)


# ---------------------------------------------------------------------------
# mixture of experts
# ---------------------------------------------------------------------------

MOE_CASES = {
    # name: (top_k, capacity_factor, shared_expert, tie)
    "top1_shared": (1, 1.25, True, False),
    "top2_ample": (2, 8.0, False, False),
    "top2_drops": (2, 0.5, False, False),
    "top3_ties": (3, 1.0, False, True),
}


def _moe_cfgs(top_k, cap, shared):
    kw = dict(name="tiny-moe", family="moe", num_layers=1, d_model=16,
              num_heads=2, num_kv_heads=2, head_dim=8,
              d_ff=24 if shared else 0, vocab_size=64)
    moe = dict(num_experts=4, top_k=top_k, d_ff_expert=32,
               shared_expert=shared, capacity_factor=cap)
    return (ModelConfig(**kw, moe=MoEConfig(**moe)),
            JModelConfig(**kw, moe=JMoEConfig(**moe)))


def _moe_inputs(case, B=2, S=12):
    top_k, cap, shared, tie = MOE_CASES[case]
    cfg, j_cfg = _moe_cfgs(top_k, cap, shared)
    jp = jax.tree.map(np.array, jit(j_init_params, tree=jmoe.def_moe(j_cfg))(
        rng=jax.random.key(3)))
    x = np.random.default_rng(4).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    if tie:
        # experts 1 and 2 share a router column: their probabilities tie
        # bit for bit; zero tokens tie all four experts
        jp["router"][:, 2] = jp["router"][:, 1]
        x[:, ::3] = 0.0
    return cfg, j_cfg, jp, x


def _jax_route(router, x, cfg):
    """The JAX package's routing, from ``moe.py:51-66``: (expert indices,
    keep mask).  Its drop fraction is held to ``moe_block``'s below."""
    m = cfg.moe
    B, S, _ = x.shape
    C = jmoe._capacity(S, m.top_k, m.num_experts, m.capacity_factor)
    probs = jax.nn.softmax(x @ router, axis=-1)
    _, idx = jax.lax.top_k(probs, m.top_k)
    oh = jax.nn.one_hot(idx, m.num_experts, dtype=jnp.int32)
    ohf = oh.reshape(B, S * m.top_k, m.num_experts)
    pos_in_e = jnp.cumsum(ohf, axis=1) - ohf
    pos = jnp.sum(pos_in_e.reshape(oh.shape) * oh, axis=-1)
    return idx, pos < C


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_block_matches(case):
    cfg, j_cfg, jp, x = _moe_inputs(case)
    out, aux = tmoe.moe_block(from_numpy(jp, device="cpu"),
                              torch.from_numpy(x), cfg=cfg)
    j_out, j_aux = jit(jmoe.moe_block, cfg=j_cfg)(
        jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
    close(out, j_out, BLOCK_TOL)
    assert aux.keys() == j_aux.keys()
    for k in aux:
        assert aux[k].dtype == torch.float32
    # the losses sum router probabilities, whose last bit depends on each
    # framework's order of sums (and XLA's compiled mean rounds the drop
    # fraction another way than its op-by-op one): AUX_TOL; the routing
    # and the port's drop fraction, exact
    for k in aux:
        close(aux[k], j_aux[k], AUX_TOL)

    _, _, _, idx, _, keep, _ = tmoe._route(torch.from_numpy(jp["router"]),
                                           torch.from_numpy(x), cfg)
    j_idx, j_keep = jit(_jax_route, cfg=j_cfg)(jnp.asarray(jp["router"]),
                                               jnp.asarray(x))
    assert np.array_equal(idx.numpy(), j_idx)
    assert np.array_equal(keep.numpy(), j_keep)
    assert float(aux["moe_drop_fraction"]) == float(
        np.float32(1.0) - np.float32(j_keep.sum()) / np.float32(j_keep.size))
    if case == "top2_drops":
        assert 0.0 < float(aux["moe_drop_fraction"]) < 1.0
    if case == "top3_ties":
        # tied probabilities: the lower expert index first
        zero_rows = idx.numpy()[:, ::3]
        assert (zero_rows == np.arange(3)).all()
        tied = (idx.numpy() == 1) | (idx.numpy() == 2)
        assert tied.any()


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_capacity_scan_runs_in_int32_as_the_references(case):
    """The one-hot and its cumulative count over the slots are int32, as
    the reference's (``moe.py:62-64``; torch's integer ``cumsum`` widens
    to int64 unless told), and the buffer positions are the reference's
    exactly."""
    from torch.utils._python_dispatch import TorchDispatchMode
    cfg, j_cfg, jp, x = _moe_inputs(case)
    scans = []

    class Scans(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.overloadpacket is torch.ops.aten.cumsum:
                scans.append((args[0].dtype, out.dtype))
            return out
    with Scans():
        _, _, _, idx, pos, keep, oh = tmoe._route(
            torch.from_numpy(jp["router"]), torch.from_numpy(x), cfg)
    assert scans == [(torch.int32, torch.int32)]
    assert oh.dtype == pos.dtype == torch.int32
    m = j_cfg.moe
    B, S, _ = x.shape
    j_oh = jax.nn.one_hot(jnp.asarray(idx.numpy()), m.num_experts,
                          dtype=jnp.int32)
    ohf = j_oh.reshape(B, S * m.top_k, m.num_experts)
    j_pos = jnp.sum((jnp.cumsum(ohf, axis=1) - ohf).reshape(j_oh.shape)
                    * j_oh, axis=-1)
    assert np.array_equal(pos.numpy(), np.asarray(j_pos))


@pytest.mark.parametrize("S", [1, 2, 7, 2048])
@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e",
                                  "moonshot-v1-16b-a3b"])
def test_capacity_is_the_references(S, arch):
    m = get_config(arch).moe
    want = jmoe._capacity(S, m.top_k, m.num_experts, m.capacity_factor)
    assert tmoe._capacity(S, m.top_k, m.num_experts,
                          m.capacity_factor) == want
    if S == 1:
        assert want == 1


# ---------------------------------------------------------------------------
# the vision frontend
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,S,grid", [(2, 16, None), (2, 16, (2, 2, 2)),
                                      (1, 2048, (1, 32, 32)),
                                      (3, 30, (2, 3, 4))])
def test_mrope_positions_are_the_references(B, S, grid):
    got = tfront.mrope_positions(B, S, grid=grid, device="cpu")
    want = np.asarray(jfront.mrope_positions(B, S, grid=grid))
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    assert np.array_equal(got.numpy(), want)


def test_frontend_embeddings_come_from_the_generator():
    for fn in (tfront.audio_frame_embeddings,
               tfront.vision_patch_embeddings):
        a = fn(torch.Generator().manual_seed(5), 2, 64, 32, device="cpu")
        b = fn(torch.Generator().manual_seed(5), 2, 64, 32, device="cpu")
        assert tuple(a.shape) == (2, 64, 32) and a.dtype == torch.float32
        assert torch.equal(a, b)
        assert abs(a.std().item() - 0.02) < 0.002
        bf = fn(torch.Generator().manual_seed(5), 1, 4, 8,
                dtype=torch.bfloat16, device="cpu")
        assert bf.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# Hymba and encoder-decoder blocks
# ---------------------------------------------------------------------------

def block_weights(j_defs, seed):
    """One block's weights drawn by the JAX package from its unstacked
    definitions (fan-in d, as a layer of a real model has), for both."""
    jp = jit(j_init_params, tree=j_defs)(rng=jax.random.key(seed))
    return jp, from_numpy(jax.tree.map(np.asarray, jp), torch.float32,
                          "cpu")


@pytest.mark.parametrize("local", [False, True])
def test_hybrid_block_prefill_and_decode_match(local):
    jm, _, tm, _ = models("hymba-1.5b")
    cfg, j_cfg = tm.cfg, jm.cfg
    t_block = thybrid.make_hybrid_block(cfg, tm.run)
    j_block = jax.jit(jhybrid.make_hybrid_block(j_cfg, jm.run),
                      static_argnames=("local_flag", "decode"))
    pl_j, pl_t = block_weights(jhybrid.def_hybrid_block(j_cfg), seed=6)
    B, S, T = 2, 12, 16
    x = np.random.default_rng(8).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    tc = map_tensors(tm.init_cache(B, T, device="cpu"), lambda c: c[1])
    jc = jax.tree.map(lambda c: c[1], jm.init_cache(B, T))
    t_out, t_nc, _ = t_block(pl_t, torch.from_numpy(x),
                             positions=torch.from_numpy(pos),
                             local_flag=local, cache_layer=tc, decode=False)
    j_out, j_nc, _ = j_block(pl_j, jnp.asarray(x), positions=jnp.asarray(pos),
                             local_flag=local, cache_layer=jc, decode=False)
    close(t_out, j_out, BLOCK_TOL)
    same_trees(t_nc, j_nc, BLOCK_TOL)
    x1 = x[:, -1:] * 0.5
    t_out, t_nc, _ = t_block(pl_t, torch.from_numpy(x1),
                             positions=t_nc["attn"]["pos"][:, None].clone(),
                             local_flag=local, cache_layer=t_nc, decode=True)
    j_out, j_nc, _ = j_block(pl_j, jnp.asarray(x1),
                             positions=j_nc["attn"]["pos"][:, None],
                             local_flag=local, cache_layer=j_nc, decode=True)
    close(t_out, j_out, BLOCK_TOL)
    same_trees(t_nc, j_nc, BLOCK_TOL)


@pytest.mark.parametrize("Sq,threshold", [(1, 2048), (6, 2048), (8, 4)])
def test_cross_attention_routes_and_matches(Sq, threshold):
    """One query (decode), full and blocked (above the threshold)."""
    jm, _, tm, _ = models("seamless-m4t-medium")
    cfg, j_cfg = tm.cfg, jm.cfg
    run = dataclasses.replace(tm.run, blocked_threshold=threshold,
                              block_q=4, block_kv=4)
    j_run = dataclasses.replace(jm.run, blocked_threshold=threshold,
                                block_q=4, block_kv=4)
    pl_j, pl_t = block_weights(jencdec.def_decoder_block(j_cfg)["cross_attn"],
                               seed=7)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, Sq, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, 8, cfg.d_model)).astype(np.float32)
    t_out = tencdec.cross_attention(pl_t, torch.from_numpy(x), cfg=cfg,
                                    run=run, enc_out=torch.from_numpy(enc))
    j_out = jit(jencdec.cross_attention, cfg=j_cfg, run=j_run)(
        pl_j, jnp.asarray(x), enc_out=jnp.asarray(enc))
    close(t_out, j_out, BLOCK_TOL)
    t_kv = tencdec._proj_kv(pl_t, torch.from_numpy(enc), cfg)
    j_kv = jencdec._proj_kv(pl_j, jnp.asarray(enc), j_cfg)
    same_trees(t_kv, j_kv, BLOCK_TOL)
    t_out = tencdec.cross_attention(pl_t, torch.from_numpy(x), cfg=cfg,
                                    run=run, kv=t_kv)
    close(t_out, j_out, BLOCK_TOL)


@pytest.mark.parametrize("impl", IMPLS)
def test_encoder_layer_matches(impl):
    """One encoder layer (weights of fan-in d) and the final norm."""
    jm, _, tm, _ = models("seamless-m4t-medium", impl)
    cfg = dataclasses.replace(tm.cfg, num_encoder_layers=1)
    j_cfg = dataclasses.replace(jm.cfg, num_encoder_layers=1)
    layer_j, layer_t = block_weights(jencdec.def_encoder_block(j_cfg), 8)
    jp = {"enc_layers": jax.tree.map(lambda a: a[None], layer_j),
          "enc_ln_final": {"scale": jnp.full((cfg.d_model,), 0.1)}}
    tp = {"enc_layers": map_tensors(layer_t, lambda a: a[None]),
          "enc_ln_final": {"scale": torch.full((cfg.d_model,), 0.1)}}
    tb, jb = batches("seamless-m4t-medium", 2, 16, seed=3)
    close(tencdec.encode(tp, tb["src_embeds"], cfg=cfg, run=tm.run),
          jit(jencdec.encode, cfg=j_cfg, run=jm.run)(jp, jb["src_embeds"]),
          BLOCK_TOL)


@pytest.mark.parametrize("impl", IMPLS)
def test_encoder_matches(impl):
    jm, jp, tm, tp = models("seamless-m4t-medium", impl)
    tb, jb = batches("seamless-m4t-medium", 2, 16, seed=3)
    near(tencdec.encode(tp, tb["src_embeds"], cfg=tm.cfg, run=tm.run),
         jit(jencdec.encode, cfg=jm.cfg, run=jm.run)(jp, jb["src_embeds"]))


# ---------------------------------------------------------------------------
# a train step: MoE and Mamba-2
# ---------------------------------------------------------------------------

OPT = adamw.OptConfig(lr=1e-2, warmup_steps=10, decay_steps=2000,
                      weight_decay=0.0)
J_OPT = jadamw.OptConfig(lr=1e-2, warmup_steps=10, decay_steps=2000,
                         weight_decay=0.0)


@pytest.fixture
def port_grads(monkeypatch):
    """The gradients each port step hands to AdamW, in order."""
    seen = []

    def recording(grads, *args, **kw):
        seen.append(map_tensors(grads, lambda g: g.detach().clone()))
        return update(grads, *args, **kw)
    update = step_mod.adamw_update
    monkeypatch.setattr(step_mod, "adamw_update", recording)
    return seen


def _moment_gap(tstate, jstate):
    worst = 0.0
    for kind in ("mu", "nu"):
        got = dict(_flat(tstate["opt"][kind]))
        want = dict(_flat(jstate["opt"][kind]))
        assert got.keys() == want.keys()
        for k in got:
            worst = max(worst, float(np.abs(got[k] - want[k]).max()
                                     / max(np.abs(want[k]).max(), 1e-30)))
    return worst


TRAIN_RUN_KW = dict(param_dtype="float32", compute_dtype="float32",
                    remat="none", loss_chunk=0)


def _one_step(arch):
    """One train step of each package from the JAX package's initial
    state on one seeded batch: (port state, port metrics, JAX state, JAX
    metrics, the initial state as numpy)."""
    jm = j_build(j_reduced(j_get_config(arch)), JRun(**TRAIN_RUN_KW))
    jstate = j_init_state(jm, jax.random.key(0))
    jstate0 = jax.tree.map(np.asarray, jstate)
    tstate = train_state_from_numpy(jstate0, device="cpu")
    rng = np.random.default_rng(5)
    toks = rng.integers(0, 256, (2, 17)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    tm = build_model(reduced_config(get_config(arch)),
                     RunConfig(**TRAIN_RUN_KW))
    tstate, tmet = make_train_step(tm, OPT)(
        tstate, {k: torch.from_numpy(v.copy()) for k, v in batch.items()})
    jstate, jmet = jax.jit(j_make_step(jm, J_OPT))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    return tstate, tmet, jstate, jmet, jstate0


def _oracle_scan(x, dt, A, Bm, Cm, *, chunk, initial_state=None,
                 return_state=False):
    """The JAX package's recurrent oracle in place of its chunked scan."""
    del chunk
    y, s = jssm.ssd_reference(x, dt, A, Bm, Cm, initial_state)
    return (y, s) if return_state else y


def test_reference_ssd_gradients_are_nan_the_ports_are_not():
    """The JAX package's chunked scan masks ``exp(cum_i - cum_j)`` after
    the exp (``ssm.py:123-126``): above the diagonal the exponent is >= 0
    and overflows at this config's step sizes, and the where's gradient
    0 * inf is NaN in every parameter.  The port masks before the exp."""
    tstate, tmet, jstate, jmet, _ = _one_step("mamba2-780m")
    assert np.isnan(float(jmet["grad_norm"]))
    assert np.isfinite(float(jmet["loss"]))
    assert np.isfinite(float(tmet["grad_norm"]))
    for _, leaf in _flat(tstate):
        assert np.isfinite(leaf).all()


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "mamba2-780m"])
def test_train_step_matches_reference(arch, port_grads, monkeypatch):
    if arch == "mamba2-780m":
        # the JAX package's gradients are finite only through its oracle
        monkeypatch.setattr(jssm, "ssd_chunked", _oracle_scan)
    tstate, tmet, jstate, jmet, jstate0 = _one_step(arch)
    assert tmet.keys() == jmet.keys()
    if arch.startswith("moonshot"):
        assert {"moe_load_balance", "moe_router_z"} <= set(tmet)
    for k in tmet:
        close(tmet[k], jmet[k], GRAD_NORM_TOL if k == "grad_norm"
              else STEP_TOL)
    assert _moment_gap(tstate, jax.tree.map(np.asarray, jstate)) <= \
        MOMENT_TOL
    params, opt, _ = jadamw.adamw_update(
        jax.tree.map(jnp.asarray, map_tensors(port_grads[-1],
                                              torch.Tensor.numpy)),
        jax.tree.map(jnp.asarray, jstate0["opt"]),
        jax.tree.map(jnp.asarray, jstate0["params"]), J_OPT)
    same_trees(tstate, {"params": jax.tree.map(np.asarray, params),
                        "opt": jax.tree.map(np.asarray, opt)}, SMALL_TOL)


def _float64_gaps():
    """(port - float64 port, JAX - float64 port, port - JAX) of each
    architecture's logits, each over the larger of 1 and the logits'
    largest magnitude: the float32 floor the whole-model bound sits on."""
    import repro_torch.configs.run as run_mod
    for arch in ARCHS:
        jm, jp, tm, tp = models(arch)
        tb, jb = batches(arch, 2, 16, seed=1)
        j_logits = jm.logits(jp, jm.forward(jp, jb)[0])
        t_logits = tm.logits(tp, tm.forward(tp, tb)[0])
        wide = run_mod._DTYPES["float32"]
        run_mod._DTYPES["float32"] = torch.float64   # the run's dtypes
        try:
            tp64 = map_tensors(tp, lambda t: t.double()
                               if t.is_floating_point() else t)
            tb64 = {k: v.double() if v.is_floating_point() else v
                    for k, v in tb.items()}
            l64 = tm.logits(tp64, tm.forward(tp64, tb64)[0]).numpy()
        finally:
            run_mod._DTYPES["float32"] = wide
        print(f"{arch}: port {scaled_gap(t_logits, l64):.3g}, JAX "
              f"{scaled_gap(j_logits, l64):.3g}, port - JAX "
              f"{scaled_gap(t_logits, j_logits):.3g}")


if __name__ == "__main__":
    _float64_gaps()

"""The port's training path against the JAX package's.

Optimizer, compression and loss are held to the JAX package on seeded
numpy inputs within 1e-6 (float32).  A train step of the tiny config of
``tests/test_train_loop.py``, with the JAX package's initial state carried
across by ``train_state_from_numpy`` and one numpy batch given to both,
from init seeds 0-3 and batches 0 and 5: loss, accuracy and learning rate
within 1e-5; the gradient norm within 1e-4 (relative) and AdamW's moments
within 1e-3 of each leaf's largest; and the port's whole new state within
1e-6 of the JAX package's AdamW applied to the port's own gradients.  The
gradient bounds are the float32 floor of this config, not of the port:
its stacked weights are drawn with std 1/sqrt(layers) = 0.71 (the JAX
package's fan-in of a stacked leaf) and the attention saturates; running
this file prints the two packages' gaps at each start.  The parameters
are not held to the JAX package's directly: AdamW's first step,
lr·g/(|g| + eps), turns a gradient difference near g = 0 into up to lr of
a parameter.  Checkpoints cross both ways bit for bit.  The data, loop
and supervisor tests are the port's versions of ``tests/test_infra.py``
and ``tests/test_train_loop.py`` (the two packages' token streams differ:
numpy Philox here, threefry there).  Everything runs on the CPU
(``device="cpu"``).
"""
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.ckpt import CheckpointManager as JCkpt
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.run import RunConfig as JRun
from repro.models.model_zoo import build_model as j_build
from repro.optim import adamw as jadamw
from repro.optim.compression import Int8ErrorFeedback as JInt8
from repro.optim.compression import quantize_int8 as j_quantize
from repro.train import loss as jloss
from repro.train.step import init_train_state as j_init_state
from repro.train.step import make_train_step as j_make_step
from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.run import RunConfig
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models.model_zoo import build_model
from repro_torch.models.params import map_tensors, train_state_from_numpy
from repro_torch.optim import adamw
from repro_torch.optim.compression import (Int8ErrorFeedback,
                                           dequantize_int8, quantize_int8)
from repro_torch.runtime.supervisor import FailurePlan, SupervisorConfig
from repro_torch.train import loss as tloss
from repro_torch.train import step as step_mod
from repro_torch.train.loop import make_job, train
from repro_torch.train.step import (_split_microbatches, init_train_state,
                                    make_train_step)

TINY_KW = dict(name="tiny-lm", family="dense", num_layers=2, d_model=64,
               num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
               vocab_size=128, tie_embeddings=True)
TINY = ModelConfig(**TINY_KW)
RUN = RunConfig(param_dtype="float32", compute_dtype="float32",
                remat="none", loss_chunk=0)
DATA = DataConfig(vocab_size=128, seq_len=64, global_batch=8, seed=3)
OPT = adamw.OptConfig(lr=1e-2, warmup_steps=10, decay_steps=2000,
                      weight_decay=0.0)
J_OPT = jadamw.OptConfig(lr=1e-2, warmup_steps=10, decay_steps=2000,
                         weight_decay=0.0)
SMALL_TOL = 1e-6        # also the new state from AdamW on the port's grads
STEP_TOL = 1e-5         # loss, accuracy, tokens, lr
GRAD_NORM_TOL = 1e-4    # relative: the gradients' float32 floor here
MOMENT_TOL = 1e-3       # of a leaf's largest: AdamW's moments after a step


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """This module's CPU work is tiny: run it on one intra-op thread, so
    that beside the suite's other workers it does not oversubscribe the
    host (and repeated tokens' gradients sum in one order)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _tree(seed, shapes=(("w", (8, 16)), ("b", (16,)))):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes}


def _t(tree):
    return map_tensors(tree, lambda a: torch.from_numpy(np.array(a)))


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree.detach().cpu().numpy()
                                 if isinstance(tree, torch.Tensor) else tree)


def _same_leaves(a, b, tol):
    fa, fb = dict(_flat(a)), dict(_flat(b))
    assert fa.keys() == fb.keys()
    for k in fa:
        _close(fa[k], fb[k], tol)


# ---------------------------------------------------------------------------
# optimizer, compression, loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("opt", [adamw.OptConfig(), OPT])
def test_lr_schedule_matches_reference(opt):
    jopt = jadamw.OptConfig(**opt.__dict__)
    steps = np.arange(0, 3001, dtype=np.int32)
    got = adamw.lr_at(opt, torch.from_numpy(steps))
    want = jadamw.lr_at(jopt, jnp.asarray(steps))
    assert got.dtype == torch.float32
    _close(got, want, SMALL_TOL)
    assert float(adamw.lr_at(opt, 7)) == pytest.approx(float(
        jadamw.lr_at(jopt, 7)), rel=SMALL_TOL)


@pytest.mark.parametrize("n_steps", [1, 3])
def test_adamw_update_matches_reference(n_steps):
    cfg = adamw.OptConfig(lr=1e-2, warmup_steps=2, decay_steps=10,
                          clip_norm=0.5)
    jcfg = jadamw.OptConfig(**cfg.__dict__)
    params = _tree(0)
    tp, jp = _t(params), _j(params)
    tst, jst = adamw.init_opt_state(tp), jadamw.init_opt_state(jp)
    for i in range(n_steps):
        grads = _tree(10 + i)
        tp, tst, tm = adamw.adamw_update(_t(grads), tst, tp, cfg)
        jp, jst, jm = jadamw.adamw_update(_j(grads), jst, jp, jcfg)
        for k in ("grad_norm", "lr"):
            _close(tm[k], jm[k], SMALL_TOL)
    _same_leaves(tp, _np(jp), SMALL_TOL)
    _same_leaves(tst["mu"], _np(jst["mu"]), SMALL_TOL)
    _same_leaves(tst["nu"], _np(jst["nu"]), SMALL_TOL)
    assert tst["step"].dtype == torch.int32
    assert int(tst["step"]) == int(jst["step"]) == n_steps


def test_global_norm_and_clipping_match_reference():
    g = _tree(3)
    _close(adamw.global_norm(_t(g)), jadamw.global_norm(_j(g)), SMALL_TOL)
    tg, tn = adamw.clip_by_global_norm(_t(g), 0.25)
    jg, jn = jadamw.clip_by_global_norm(_j(g), 0.25)
    _close(tn, jn, SMALL_TOL)
    _same_leaves(tg, _np(jg), SMALL_TOL)


def test_int8_quantization_matches_reference():
    x = np.random.default_rng(4).standard_normal((33, 7)).astype(np.float32)
    x[0, 0] = 2.5 * np.abs(x).max() / 127   # a tie: rounds half to even
    q, s = quantize_int8(torch.from_numpy(x))
    jq, js = j_quantize(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    _close(s, js, SMALL_TOL)
    _close(dequantize_int8(q, s), np.asarray(jq, np.float32) * float(js),
           SMALL_TOL)


def test_error_feedback_apply_matches_reference():
    params = _tree(5)
    ef, jef = Int8ErrorFeedback(), JInt8()
    tstate = {"ef_error": ef.init_error(_t(params))}
    jstate = {"ef_error": jef.init_error(_j(params))}
    for i in range(3):
        grads = _tree(20 + i)
        tg, tstate, tm = ef.apply(_t(grads), tstate)
        jg, jstate, jm = jef.apply(_j(grads), jstate)
        _same_leaves(tg, _np(jg), SMALL_TOL)
        _same_leaves(tstate["ef_error"], _np(jstate["ef_error"]), SMALL_TOL)
        _close(tm["ef_error_norm"], jm["ef_error_norm"], SMALL_TOL)
    assert Int8ErrorFeedback.wire_bytes_saved(_t(params)) == \
        JInt8.wire_bytes_saved(_j(params))


@pytest.mark.parametrize("chunk", [0, 8, 16, 12])
def test_cross_entropy_chunked_matches_reference(chunk):
    rng = np.random.default_rng(6)
    B, S, D, V = 2, 32, 16, 40
    h = rng.standard_normal((B, S, D)).astype(np.float32)
    w = rng.standard_normal((D, V)).astype(np.float32)
    tgt = rng.integers(0, V, (B, S)).astype(np.int32)
    th = torch.from_numpy(h).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    loss, met = tloss.cross_entropy(lambda x: x @ tw, th,
                                    torch.from_numpy(tgt), chunk)
    gh, gw = torch.autograd.grad(loss, (th, tw))

    def jf(h, w):
        return jloss.cross_entropy(lambda x: x @ w, h, jnp.asarray(tgt),
                                   chunk)
    (jl_, jmet), (jgh, jgw) = jax.value_and_grad(jf, argnums=(0, 1),
                                                 has_aux=True)(
        jnp.asarray(h), jnp.asarray(w))
    _close(loss.detach(), jl_, SMALL_TOL)
    for k in ("accuracy", "tokens"):
        _close(met[k], jmet[k], SMALL_TOL)
    _close(gh, jgh, SMALL_TOL)
    _close(gw, jgw, SMALL_TOL)
    # chunked against unchunked within the port
    whole, _ = tloss.cross_entropy(lambda x: x @ tw, th,
                                   torch.from_numpy(tgt), 0)
    _close(loss.detach(), whole.detach(), SMALL_TOL)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def _jax_state_and_port(run_kw, seed=0):
    jm = j_build(JModelConfig(**TINY_KW), JRun(**run_kw))
    jstate = j_init_state(jm, jax.random.key(seed))
    return jm, jstate, train_state_from_numpy(_np(jstate), device="cpu")


def _batch(step=0):
    both = SyntheticLM(DATA, device="cpu").host_batch_at(step)
    return ({"tokens": torch.from_numpy(both[0]),
             "targets": torch.from_numpy(both[1])},
            {"tokens": jnp.asarray(both[0]), "targets": jnp.asarray(both[1])})


_F32 = dict(param_dtype="float32", compute_dtype="float32", remat="none")
# init seeds and batches beside (0, 0) over which the step is held
OTHER_STARTS = [(s, b) for s in range(4) for b in (0, 5) if (s, b) != (0, 0)]


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
    """The largest |port - JAX| of AdamW's moments, over each leaf's
    largest |JAX|."""
    worst = 0.0
    for kind in ("mu", "nu"):
        got, want = dict(_flat(tstate["opt"][kind])), dict(_flat(
            jstate["opt"][kind]))
        assert got.keys() == want.keys()
        for k in got:
            worst = max(worst, float(np.abs(got[k] - want[k]).max()
                                     / max(np.abs(want[k]).max(), 1e-30)))
    return worst


def _steps(run_kw, seed=0, batch_step=0):
    """One step of each package from the JAX package's state drawn with
    ``seed``, on batch ``batch_step``: the port's (state, metrics), the
    JAX package's, and the starting state as numpy."""
    jm, jstate, tstate = _jax_state_and_port(run_kw, seed)
    jstate0 = _np(jstate)
    tb, jb = _batch(batch_step)
    tstate, tmet = make_train_step(build_model(TINY, RunConfig(**run_kw)),
                                   OPT)(tstate, tb)
    jstate, jmet = jax.jit(j_make_step(jm, J_OPT))(jstate, jb)
    return tstate, tmet, jstate, jmet, jstate0


def _same_step(tmet, jmet, tstate, jstate, tgrads, jstate0):
    """One port step against the JAX package's from the same state
    ``jstate0``: metrics, the moments (to MOMENT_TOL of each leaf's
    largest), and the whole new state against the JAX package's AdamW
    applied to the port's own gradients ``tgrads``."""
    assert tmet.keys() == jmet.keys()
    for k in tmet:
        _close(tmet[k], jmet[k], GRAD_NORM_TOL if k == "grad_norm"
               else STEP_TOL)
    assert _moment_gap(tstate, _np(jstate)) <= MOMENT_TOL
    params, opt, _ = jadamw.adamw_update(
        _j(map_tensors(tgrads, torch.Tensor.numpy)), _j(jstate0["opt"]),
        _j(jstate0["params"]), J_OPT)
    _same_leaves(tstate, {"params": _np(params), "opt": _np(opt)}, SMALL_TOL)


@pytest.mark.parametrize("run_kw", [
    dict(_F32, loss_chunk=0),
    dict(_F32, loss_chunk=16),
    dict(_F32, loss_chunk=0, attn_impl="blocked", block_q=16, block_kv=32),
])
def test_train_step_matches_reference(run_kw, port_grads):
    tstate, tmet, jstate, jmet, jstate0 = _steps(run_kw)
    _same_step(tmet, jmet, tstate, jstate, port_grads[-1], jstate0)
    assert tstate["params"]["embed"].dtype == torch.float32
    assert int(tstate["opt"]["step"]) == 1


@pytest.mark.parametrize("seed,batch_step", OTHER_STARTS)
def test_train_step_matches_reference_from_other_starts(seed, batch_step,
                                                        port_grads):
    tstate, tmet, jstate, jmet, jstate0 = _steps(dict(_F32, loss_chunk=0),
                                                 seed, batch_step)
    _same_step(tmet, jmet, tstate, jstate, port_grads[-1], jstate0)


def test_microbatches_match_one_batch_and_the_reference(port_grads):
    states, mets = {}, {}
    for m in (1, 2):
        states[m], mets[m], jstate, jmet, jstate0 = _steps(
            dict(_F32, loss_chunk=0, microbatches=m))
        _same_step(mets[m], jmet, states[m], jstate, port_grads[-1],
                   jstate0)
    # the JAX package's own tolerance for m against 1
    for (ka, a), (kb, b) in zip(_flat(states[1]["params"]),
                                _flat(states[2]["params"])):
        np.testing.assert_allclose(a, b, atol=2e-5, rtol=2e-4)
    _close(mets[1]["loss"], mets[2]["loss"], STEP_TOL)


def test_split_microbatches_keeps_mrope_positions_batch_major():
    pos = torch.arange(3 * 4 * 5).reshape(3, 4, 5)
    tok = torch.arange(4 * 5).reshape(4, 5)
    mb = _split_microbatches({"positions": pos, "tokens": tok}, 2)
    assert tuple(mb["positions"].shape) == (2, 3, 2, 5)
    assert torch.equal(mb["positions"][1], pos[:, 2:])
    assert torch.equal(mb["tokens"][1], tok[2:])
    with pytest.raises(ValueError, match="microbatches"):
        _split_microbatches({"tokens": tok}, 3)


@pytest.mark.parametrize("attn_impl", ["full", "blocked"])
def test_remat_changes_no_number(attn_impl):
    tb, _ = _batch()
    out = {}
    for remat in ("none", "dots", "full"):
        run = RunConfig(param_dtype="float32", compute_dtype="float32",
                        remat=remat, loss_chunk=16, attn_impl=attn_impl,
                        block_q=16, block_kv=32)
        model = build_model(TINY, run)
        state = init_train_state(model, torch.Generator().manual_seed(0),
                                 device="cpu")
        out[remat] = make_train_step(model, OPT)(state, tb)
    for remat in ("dots", "full"):
        for (ka, a), (kb, b) in zip(_flat(out["none"][0]),
                                    _flat(out[remat][0])):
            assert ka == kb and np.array_equal(a, b), (remat, ka)
        assert torch.equal(out["none"][1]["loss"], out[remat][1]["loss"])


def test_bf16_compute_gradients_reach_f32_master_params():
    run = RunConfig(compute_dtype="bfloat16", remat="full", loss_chunk=16,
                    attn_impl="blocked", block_q=16, block_kv=32)
    model = build_model(TINY, run)
    state = init_train_state(model, torch.Generator().manual_seed(1),
                             device="cpu")
    before = state["params"]["embed"].clone()
    state, met = make_train_step(model, OPT)(state, _batch()[0])
    assert state["params"]["embed"].dtype == torch.float32
    assert not torch.equal(before, state["params"]["embed"])
    assert torch.isfinite(met["loss"]) and met["grad_norm"] > 0
    assert {a.dtype for _, a in _flat(state["opt"]["mu"])} == {
        np.dtype(np.float32)}


def test_train_state_from_numpy_names_what_is_missing():
    with pytest.raises(ValueError, match="step"):
        train_state_from_numpy({"params": {}, "opt": {"mu": {}, "nu": {}}},
                               device="cpu")


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _state(seed=0):
    rng = np.random.default_rng(seed)
    return {"params": {"w": rng.standard_normal((8, 16)).astype(np.float32),
                       "b": np.zeros((16,), np.float32)},
            "opt": {"mu": {"w": np.ones((8, 16), np.float32),
                           "b": np.zeros((16,), np.float32)},
                    "step": np.int32(7)}}


def test_checkpoint_roundtrip_and_gc(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2, device="cpu")
    for step in (10, 20, 30):
        cm.save(step, _t(_state(step)))
    assert cm.all_steps() == [20, 30]            # gc keeps 2
    got, extra = cm.restore(20)
    np.testing.assert_array_equal(got["params"]["w"].numpy(),
                                  _state(20)["params"]["w"])
    assert got["opt"]["step"].dtype == torch.int32
    assert int(got["opt"]["step"]) == 7 and extra == {}


def test_checkpoint_uncommitted_invisible(tmp_path):
    cm = CheckpointManager(str(tmp_path), device="cpu")
    cm.save(5, _t(_state()))
    os.remove(os.path.join(str(tmp_path), "step_00000005", "COMMIT"))
    assert cm.latest_step() is None
    with pytest.raises(FileNotFoundError):
        cm.restore()


def test_checkpoint_corruption_detected(tmp_path):
    cm = CheckpointManager(str(tmp_path), device="cpu")
    cm.save(1, _t(_state()))
    d = os.path.join(str(tmp_path), "step_00000001")
    victim = [f for f in os.listdir(d) if f.endswith(".npy")][0]
    arr = np.load(os.path.join(d, victim))
    np.save(os.path.join(d, victim), arr + 1)
    with pytest.raises(IOError, match="corruption"):
        cm.restore(1)


def test_checkpoint_async_snapshots_before_an_in_place_update(tmp_path):
    cm = CheckpointManager(str(tmp_path), device="cpu")
    state = _t(_state())
    want = state["params"]["w"].clone()
    cm.save_async(3, state, {"step": 3})
    state["params"]["w"].add_(1.0)       # the next step, in place
    cm.wait()
    assert cm.latest_step() == 3
    got, extra = cm.restore()
    assert torch.equal(got["params"]["w"], want) and extra == {"step": 3}


def test_checkpoint_restore_places_leaves_on_the_given_device(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    cm.save(1, _t(_state()))
    got, _ = cm.restore(1, device="cpu")
    assert got["params"]["w"].device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cm.restore(1)               # the manager's default is "cuda"


def _train_state():
    jm = j_build(JModelConfig(**TINY_KW), JRun(**_F32, loss_chunk=0))
    return _np(j_init_state(jm, jax.random.key(2), compress=JInt8()))


def test_checkpoint_written_by_jax_restores_in_the_port(tmp_path):
    state = _train_state()
    JCkpt(str(tmp_path)).save(4, state, {"step": 4})
    got, extra = CheckpointManager(str(tmp_path), device="cpu").restore()
    assert extra == {"step": 4}
    want = dict(_flat(state))
    for name, arr in _flat(got):
        assert arr.dtype == want[name].dtype
        np.testing.assert_array_equal(arr, want[name])
    assert set(dict(_flat(got))) == set(want)


def test_checkpoint_written_by_the_port_restores_in_jax(tmp_path):
    state = train_state_from_numpy(_train_state(), device="cpu")
    CheckpointManager(str(tmp_path)).save(6, state, {"step": 6})
    got, extra = JCkpt(str(tmp_path)).restore()
    assert extra == {"step": 6}
    want = dict(_flat(state))
    for name, arr in _flat(_np(got)):
        assert arr.dtype == want[name].dtype
        np.testing.assert_array_equal(arr, want[name])
    # and the manifests agree leaf for leaf, hashes included
    jdir = tmp_path / "jax"
    JCkpt(str(jdir)).save(6, _np(got))
    import json
    mine = json.load(open(tmp_path / "step_00000006" / "manifest.json"))
    theirs = json.load(open(jdir / "step_00000006" / "manifest.json"))
    assert mine["leaves"] == theirs["leaves"]


def test_bf16_leaves_cross_into_the_port_but_not_back_into_jax(tmp_path):
    """A bf16 leaf is stored as two-byte words (numpy has no bf16 kind);
    the JAX package's own restore cannot read them back (its bf16 leaf
    loads as ``|V2``), so only the port reads either package's."""
    w = np.random.default_rng(8).standard_normal((4, 6)).astype(np.float32)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    JCkpt(jdir).save(1, {"w": jnp.asarray(w, jnp.bfloat16)})
    CheckpointManager(tdir).save(1, {"w": torch.from_numpy(w).to(
        torch.bfloat16)})
    want = torch.from_numpy(w).to(torch.bfloat16)
    for d in (jdir, tdir):
        got, _ = CheckpointManager(d, device="cpu").restore()
        assert got["w"].dtype == torch.bfloat16
        assert torch.equal(got["w"], want)
        with pytest.raises(TypeError, match="V2"):
            JCkpt(d).restore()
    import json
    for d in (jdir, tdir):
        meta = json.load(open(os.path.join(d, "step_00000001",
                                           "manifest.json")))
        assert meta["leaves"]["w"]["dtype"] == "bfloat16"
    assert json.load(open(os.path.join(jdir, "step_00000001",
                                       "manifest.json")))["leaves"]["w"][
        "sha1"] == json.load(open(os.path.join(
            tdir, "step_00000001", "manifest.json")))["leaves"]["w"]["sha1"]


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------

def test_data_deterministic_and_resumable():
    cfg = DataConfig(vocab_size=97, seq_len=32, global_batch=8, seed=5)
    b1 = SyntheticLM(cfg, device="cpu").batch_at(42)
    b2 = SyntheticLM(cfg, device="cpu").batch_at(42)
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert b1["tokens"].dtype == b1["targets"].dtype == torch.int32
    assert torch.equal(b1["tokens"][:, 1:], b1["targets"][:, :-1])
    assert not torch.equal(b1["tokens"], SyntheticLM(cfg, device="cpu")
                           .batch_at(43)["tokens"])
    it = SyntheticLM(cfg, device="cpu").iterate(42)
    assert torch.equal(next(it)["tokens"], b1["tokens"])
    assert SyntheticLM(cfg, device="cpu").state(42) == {
        "seed": 5, "step": 42, "structure": 0.8}


def test_data_shards_are_disjoint_slices():
    cfg = DataConfig(vocab_size=97, seq_len=16, global_batch=8, seed=1)
    d = SyntheticLM(cfg, device="cpu")
    s0 = d.batch_at(3, shard_index=0, num_shards=2)
    s1 = d.batch_at(3, shard_index=1, num_shards=2)
    assert tuple(s0["tokens"].shape) == (4, 16)
    assert not torch.equal(s0["tokens"], s1["tokens"])
    with pytest.raises(ValueError, match="shards"):
        d.batch_at(3, num_shards=3)


@pytest.mark.parametrize("step", [0, 1, 17, 999, 1000])
def test_data_structure_learnable(step):
    cfg = DataConfig(vocab_size=64, seq_len=64, global_batch=2, seed=0,
                     structure=1.0)
    t = SyntheticLM(cfg, device="cpu").batch_at(step)["tokens"].numpy()
    np.testing.assert_array_equal((31 * t[:, :-1] + 17) % 64, t[:, 1:])


# ---------------------------------------------------------------------------
# loop and supervisor
# ---------------------------------------------------------------------------

def _job(tmp_path, name, **kw):
    sup = kw.pop("sup_cfg", SupervisorConfig(ckpt_every=1000))
    return make_job(TINY, RUN, opt=OPT, data_cfg=DATA,
                    ckpt_dir=str(tmp_path / name), sup_cfg=sup,
                    device="cpu", **kw)


def test_loss_decreases(tmp_path):
    out = train(_job(tmp_path, "ck"), 100, resume=False)
    early = np.mean(out["losses"][:5])
    late = np.mean(out["losses"][-5:])
    assert late < early - 1.0, (early, late)


def test_checkpoint_exact_resume(tmp_path):
    cont = train(_job(tmp_path, "a"), 20, resume=False)
    train(_job(tmp_path, "b", sup_cfg=SupervisorConfig(ckpt_every=10)), 10,
          resume=False)
    resumed = train(_job(tmp_path, "b"), 10, resume=True)
    np.testing.assert_allclose(resumed["losses"][-1], cont["losses"][-1],
                               rtol=1e-5)
    for (ka, a), (kb, b) in zip(_flat(cont["state"]["params"]),
                                _flat(resumed["state"]["params"])):
        assert ka == kb
        np.testing.assert_allclose(a, b, atol=1e-6)


def test_failure_recovery(tmp_path):
    job = _job(tmp_path, "ck", sup_cfg=SupervisorConfig(ckpt_every=5))
    plan = FailurePlan(fail_at_steps={12: "node_lost"})
    out = train(job, 25, resume=False, failure_plan=plan)
    rep = out["report"]
    assert rep.restarts == 1
    assert rep.restored_from == [10]         # last committed ckpt before 12
    assert rep.failures == ["InjectedFailure: node_lost@12"]
    assert len(out["losses"]) >= 25          # replayed steps counted
    assert np.mean(out["losses"][-3:]) < np.mean(out["losses"][:3])


def test_restore_frees_the_failed_runs_state(tmp_path, monkeypatch):
    """The step updates the state in place, so after a restore nothing may
    keep the failed run's tensors alive (on a card: a second copy of
    weights and moments)."""
    import gc
    import weakref
    from repro_torch.train import loop
    seen = []

    def init(*a, **kw):
        state = init_train_state(*a, **kw)
        seen.append(weakref.ref(state["params"]["embed"]))
        return state

    monkeypatch.setattr(loop, "init_train_state", init)
    job = _job(tmp_path, "ck", sup_cfg=SupervisorConfig(ckpt_every=2))

    def probe(state, batch):
        if len(job.supervisor.report.restored_from) == 1:
            gc.collect()
            assert seen[0]() is None      # only the restored state lives
        return step(state, batch)

    step, job.step_fn = job.step_fn, probe
    out = train(job, 4, resume=False,
                failure_plan=FailurePlan(fail_at_steps={3: "node_lost"}))
    assert out["report"].restored_from == [2]


def test_straggler_detection(tmp_path):
    job = _job(tmp_path, "ck", sup_cfg=SupervisorConfig(
        ckpt_every=1000, straggler_tolerance=2.0, predicted_step_s=1e-4))
    state = init_train_state(job.model, torch.Generator().manual_seed(0),
                             device="cpu")
    state, _ = job.supervisor.run(state=state, step_fn=job.step_fn,
                                  batch_fn=job.data.batch_at, num_steps=3)
    ev0 = len(job.supervisor.report.straggler_events)

    def slow_step(state, batch):
        time.sleep(0.25)
        return job.step_fn(state, batch)

    job.supervisor._ema = 1e-3
    job.supervisor.run(state=state, step_fn=slow_step,
                       batch_fn=job.data.batch_at, num_steps=1)
    events = job.supervisor.report.straggler_events
    assert len(events) > ev0 and events[-1]["duration_s"] >= 0.25


@pytest.fixture(scope="module")
def uncompressed_run(tmp_path_factory):
    return train(_job(tmp_path_factory.mktemp("base"), "a"), 80,
                 resume=False)


def test_grad_compression_converges(tmp_path, uncompressed_run):
    base = uncompressed_run
    out_c = train(_job(tmp_path, "b", compress=True), 80, resume=False,
                  compress=True)
    assert "ef_error" in out_c["state"]
    assert np.mean(out_c["losses"][-5:]) < np.mean(out_c["losses"][:5]) - 0.8
    assert abs(np.mean(out_c["losses"][-5:]) -
               np.mean(base["losses"][-5:])) < 0.35
    assert Int8ErrorFeedback.wire_bytes_saved(base["state"]["params"]) > 0


def test_run_grad_compression_is_read_by_nothing_as_in_the_reference(
        tmp_path):
    """``make_job``/``train(compress=)`` switch compression in both
    packages; ``RunConfig.grad_compression`` alone leaves it off."""
    run = RunConfig(param_dtype="float32", compute_dtype="float32",
                    remat="none", loss_chunk=0, grad_compression="int8_ef")
    job = make_job(TINY, run, opt=OPT, data_cfg=DATA,
                   ckpt_dir=str(tmp_path), device="cpu",
                   sup_cfg=SupervisorConfig(ckpt_every=1000))
    out = train(job, 1, resume=False)
    assert "ef_error" not in out["state"]


if __name__ == "__main__":
    # the float32 gap between the two packages' steps at each start the
    # tests hold: PYTHONPATH=src python tests/test_torch_train.py
    torch.set_num_threads(1)
    for seed, b in [(0, 0)] + OTHER_STARTS:
        ts, tm_, js, jm_, _ = _steps(dict(_F32, loss_chunk=0), seed, b)
        js = _np(js)
        par = max(float(np.abs(x - y).max()) for (_, x), (_, y) in zip(
            _flat(ts["params"]), _flat(js["params"])))
        norm = abs(float(tm_["grad_norm"]) / float(jm_["grad_norm"]) - 1)
        print(f"seed {seed} batch {b}: moments {_moment_gap(ts, js):.3g} "
              f"of a leaf's largest, gradient norm {norm:.3g} (relative), "
              f"parameters {par:.3g}")

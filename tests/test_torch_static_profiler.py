"""The port's static profiler against the JAX package's HLO walker.

The JAX package's ``profile_step`` compiles a step on the CPU and walks
its HLO (``core/hlo_analysis.py``; the models here run attention
``"full"``, so no Pallas kernel is reached); the port's runs the step
once under ``op_analysis.OpCounter``.  Both see the same configurations
in float32 (``compute_dtype="float32"``): a forward plus logits of the
tiny dense config of ``tests/test_torch_train.py`` and of each family's
``reduced_config``, and the tiny config's train step (``remat="none"``,
``loss_chunk=0``).

Exact: dot flops (the walker's counted over dot and convolution
instructions only), ``dot_bytes`` (the profile's ``hbm_bytes``), the
``"scan"`` sample count and its glue/scan order; meta tensors against CPU
tensors, every count.  Within ``FLOPS_TOL``: total flops, which add the
elementwise work, where the two frameworks' lowerings differ (the port
counts an aten op, the walker an HLO op after XLA:CPU's rewrites).  Where
a family misses exact parity, the test says where and by how much.
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
from repro.configs.run import RunConfig as JRun
from repro.core import hlo_analysis
from repro.core import profile_step as j_profile_step
from repro.models.model_zoo import build_model as j_build
from repro.optim.adamw import OptConfig as JOptConfig
from repro.train.step import init_train_state as j_init_state
from repro.train.step import make_train_step as j_make_step
from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.run import RunConfig
from repro_torch.core import (CollectiveOp, OpCost, attribute_axes,
                              count_ops, op_analysis, profile_step,
                              profile_traced, sample_breakdown)
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.frontends import mrope_positions
from repro_torch.models.model_zoo import build_model
from repro_torch.optim.adamw import OptConfig
from repro_torch.train.step import init_train_state, make_train_step

TINY_KW = dict(name="tiny-lm", family="dense", num_layers=2, d_model=64,
               num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
               vocab_size=128, tie_embeddings=True)
F32 = dict(param_dtype="float32", compute_dtype="float32",
           cache_dtype="float32")
TRAIN_KW = dict(param_dtype="float32", compute_dtype="float32",
                remat="none", loss_chunk=0)
B, S = 2, 32
# total flops: 2% where attention and MLPs dominate (the port counts
# 0.2-0.5% fewer elementwise flops: XLA:CPU's rewrites of rope, masks and
# norms); 10% for the SSD scan of Mamba-2 and Hymba, where XLA:CPU emits
# elementwise multiplies and adds the port's formulation does not (the
# walker counts 722,944 multiplies and 651,904 adds in Mamba-2's layer
# body, the port 256,000 and 177,920: the port sits 8.75% and 4.77%
# below it)
FLOPS_TOL = {"ssm": 0.10, "hybrid": 0.10}
FLOPS_TOL_DEFAULT = 0.02

# (case id, arch or "tiny", layers or None for the config's own)
FORWARD_CASES = [
    ("tiny", "tiny", None),
    ("llama4-scout", "llama4-scout-17b-a16e", None),
    ("moonlight", "moonshot-v1-16b-a3b", None),
    ("qwen2-vl", "qwen2-vl-2b", None),
    ("mamba2", "mamba2-780m", None),
    ("hymba", "hymba-1.5b", None),
    ("seamless-m4t", "seamless-m4t-medium", None),
    # a pair scan (gemma2's local/global pairs) of two trips
    ("gemma2-4", "gemma2-2b", 4),
    # single layers outside any scan (Hymba's first, middle and last),
    # whose SSD chunk loop then samples on its own, as in the walker
    ("hymba-7", "hymba-1.5b", 7),
    # a one-trip scan, which XLA inlines: glue only
    ("qwen2-1", "qwen2-7b", 1),
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU work: one intra-op thread beside the suite's workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


class _DotOnly(hlo_analysis.ModuleCost):
    """The walker with every leaf but dots and convolutions costing no
    flops: its dot-only count."""

    def _instr_cost(self, instr, comp):
        cost = super()._instr_cost(instr, comp)
        if instr.opcode not in ("dot", "convolution", "fusion", "while",
                                "conditional", "call"):
            cost.flops = cost.transcendentals = 0.0
        return cost


def ref_dot_flops(compiled) -> float:
    return _DotOnly(compiled.as_text()).cost().flops


def configs(arch, layers):
    if arch == "tiny":
        jc, tc = JModelConfig(**TINY_KW), ModelConfig(**TINY_KW)
    else:
        jc, tc = j_reduced(j_get_config(arch)), reduced_config(
            get_config(arch))
    if layers is not None:
        jc = dataclasses.replace(jc, num_layers=layers)
        tc = dataclasses.replace(tc, num_layers=layers)
    return jc, tc


def forward_batch(cfg):
    """Seeded numpy inputs of a forward of ``cfg``: (port, JAX)."""
    rng = np.random.default_rng(0)
    if cfg.family == "encdec":
        arrays = {"src_embeds": rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32),
            "tgt_tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
                np.int32)}
    elif cfg.frontend == "vision_patches":
        arrays = {"embeds": rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32),
            "positions": mrope_positions(B, S, grid=(2, 2, 2),
                                         device="cpu").numpy()}
    else:
        arrays = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
            np.int32)}
    return ({k: torch.from_numpy(v.copy()) for k, v in arrays.items()},
            {k: jnp.asarray(v) for k, v in arrays.items()})


def _logits_fn(model):
    def fn(params, batch):
        hidden, _, _ = model.forward(params, batch)
        return model.logits(params, hidden)
    return fn


@functools.lru_cache(maxsize=None)
def forward_profiles(arch, layers, dtype="float32"):
    """(JAX profile, JAX dot flops, port profile, port cost, port model,
    port params, port batch) of one forward plus logits."""
    run = dict(F32, compute_dtype=dtype)
    jc, tc = configs(arch, layers)
    jm = j_build(jc, JRun(attn_impl="full", remat="none", **run))
    tm = build_model(tc, RunConfig(attn_impl="full", remat="none", **run))
    tbatch, jbatch = forward_batch(tc)
    jparams = jax.eval_shape(jm.init, jax.random.key(0))
    jprof, compiled = j_profile_step(_logits_fn(jm), jparams, jbatch,
                                     command="ref")
    tparams = tm.init(torch.Generator().manual_seed(0), device="cpu")
    tprof, cost = profile_step(_logits_fn(tm), tparams, tbatch,
                               command="port", device="cpu")
    return (jprof, ref_dot_flops(compiled), tprof, cost, tm, tparams,
            tbatch)


@functools.lru_cache(maxsize=None)
def step_profiles():
    """The tiny config's train step in both packages, and the port's on
    meta tensors: (JAX profile, JAX dot flops, port profile, port cost,
    meta profile, meta cost)."""
    jm = j_build(JModelConfig(**TINY_KW), JRun(**TRAIN_KW))
    tm = build_model(ModelConfig(**TINY_KW), RunConfig(**TRAIN_KW))
    toks = np.random.default_rng(0).integers(0, 128, (B, S + 1)).astype(
        np.int32)
    arrays = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    jprof, compiled = j_profile_step(
        j_make_step(jm, JOptConfig()), j_init_state(jm, jax.random.key(0)),
        {k: jnp.asarray(v) for k, v in arrays.items()}, command="ref")
    step = make_train_step(tm, OptConfig())
    out = []
    for device in ("cpu", "meta"):
        state = init_train_state(tm, torch.Generator().manual_seed(0),
                                 device="cpu")
        out += profile_step(step, state, {k: torch.from_numpy(v.copy())
                                          for k, v in arrays.items()},
                            command="port", device=device)
    return (jprof, ref_dot_flops(compiled), *out)


def kinds(profile):
    """glue/scan per sample, the walker's labels without the loop name."""
    return [s.label.split(":")[0] for s in profile.samples]


def family_tol(arch):
    if arch == "tiny":
        return FLOPS_TOL_DEFAULT
    return FLOPS_TOL.get(reduced_config(get_config(arch)).family,
                         FLOPS_TOL_DEFAULT)


# ---------------------------------------------------------------------------
# parity with the walker
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case,arch,layers", FORWARD_CASES,
                         ids=[c[0] for c in FORWARD_CASES])
def test_forward_dots_and_samples_match_the_walker(case, arch, layers):
    jprof, jdots, tprof, cost, *_ = forward_profiles(arch, layers)
    assert cost.dot_flops == jdots
    assert cost.dot_bytes == jprof.totals.hbm_bytes
    assert tprof.totals.hbm_bytes == cost.dot_bytes
    assert tprof.sysinfo == {"backend": "torch-static"}
    want = kinds(jprof)
    if arch == "qwen2-vl-2b":
        # XLA hoists the loop-invariant causal mask and M-RoPE tables out
        # of the layer scan into the entry computation, a glue sample
        # before the first trip that holds no dot; the port computes them
        # in every layer, so its first sample is layer 0's: one sample
        # fewer (the walker's 6,168 flops of that glue land in the port's
        # layers)
        assert want[0] == "glue" and jprof.samples[1].label != "glue"
        want = want[1:]
    assert kinds(tprof) == want
    if case == "tiny":      # the numbers this config gives on this tree
        assert (cost.dot_flops, cost.dot_bytes, len(tprof.samples)) == (
            11_534_336, 1_130_496, 4)


@pytest.mark.parametrize("case,arch,layers", FORWARD_CASES,
                         ids=[c[0] for c in FORWARD_CASES])
def test_forward_total_flops_within_tolerance(case, arch, layers):
    jprof, _, tprof, cost, *_ = forward_profiles(arch, layers)
    assert tprof.totals.flops == cost.flops
    assert cost.flops >= cost.dot_flops
    rel = abs(cost.flops - jprof.totals.flops) / jprof.totals.flops
    assert rel <= family_tol(arch), rel


def test_train_step_dots_and_samples_match_the_walker():
    jprof, jdots, tprof, cost, _, _ = step_profiles()
    assert cost.dot_flops == jdots == 34_603_008
    assert cost.dot_bytes == jprof.totals.hbm_bytes
    # glue, 2 forward layers, glue, 2 backward layers, glue
    assert kinds(tprof) == kinds(jprof) == [
        "glue", "scan", "scan", "glue", "scan", "scan", "glue"]
    assert [s.label for s in tprof.samples[4:6]] == ["scan:layers.grad"] * 2
    rel = abs(cost.flops - jprof.totals.flops) / jprof.totals.flops
    assert rel <= FLOPS_TOL_DEFAULT, rel


# ---------------------------------------------------------------------------
# meta tensors, granularity, memory
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case,arch,layers", FORWARD_CASES,
                         ids=[c[0] for c in FORWARD_CASES])
def test_meta_counts_equal_cpu_counts(case, arch, layers):
    _, _, tprof, cost, tm, tparams, tbatch = forward_profiles(arch, layers)
    launches = fa_kernel.launches
    mprof, mcost = profile_step(_logits_fn(tm), tparams, tbatch,
                                command="port", device="meta")
    assert mcost == cost
    assert [s.to_dict() for s in mprof.samples] == \
        [s.to_dict() for s in tprof.samples]
    assert mprof.meta["memory"] == tprof.meta["memory"]
    assert fa_kernel.launches == launches


def test_train_step_meta_counts_equal_cpu_counts():
    _, _, tprof, cost, mprof, mcost = step_profiles()
    assert mcost == cost
    assert [s.to_dict() for s in mprof.samples] == \
        [s.to_dict() for s in tprof.samples]
    assert mprof.meta["memory"] == tprof.meta["memory"]
    mem = tprof.meta["memory"]
    assert mem["argument_bytes"] > 0 and mem["output_bytes"] > 0
    assert mem["temp_bytes"] > 0
    assert tprof.meta["trace_s"] > 0


def test_step_granularity_is_one_sample():
    _, _, tprof, cost, tm, tparams, tbatch = forward_profiles("tiny", None)
    sprof, scost = profile_step(_logits_fn(tm), tparams, tbatch,
                                command="port", granularity="step",
                                device="cpu")
    assert scost == cost
    assert [s.label for s in sprof.samples] == ["step"]
    assert sprof.samples[0].resources.flops == cost.flops
    assert sprof.totals.flops == tprof.totals.flops
    assert sprof.totals.hbm_bytes == tprof.totals.hbm_bytes
    with pytest.raises(ValueError, match="granularity"):
        profile_step(_logits_fn(tm), tparams, tbatch, command="port",
                     granularity="op", device="cpu")


def test_bf16_dot_bytes_are_the_bytes_the_dots_move():
    """In bf16 the port's dot bytes are what its dots move: the weights and
    activations in bf16, the attention logits product in float32 (the
    port upcasts q and k there) and its probabilities cast to bf16 for the
    product with v.  The walker reads 1,105,920: XLA:CPU upcasts most bf16
    dots to float32 in the HLO it walks."""
    jprof, jdots, tprof, cost, *_ = forward_profiles("tiny", None,
                                                     "bfloat16")
    T, d, hd, hq, hk, ff, V = B * S, 64, 16, 4, 2, 128, 128

    def mm(m, k, n):                          # bf16 [m,k] @ [k,n]
        return 2 * (m * k + k * n + m * n)

    per_layer = (mm(T, d, hq * hd) + 2 * mm(T, d, hk * hd)   # q, k, v
                 + 4 * (T * hq * hd + T * hk * hd + B * hq * S * S)
                 + 2 * (B * hq * S * S + T * hk * hd + T * hq * hd)
                 + mm(T, hq * hd, d)                         # o
                 + 2 * mm(T, d, ff) + mm(T, ff, d))          # MLP
    analytic = 2 * per_layer + mm(T, d, V)                   # logits
    assert analytic == 622_592
    assert cost.dot_bytes == analytic
    assert cost.dot_flops == jdots
    assert jprof.totals.hbm_bytes == 1_105_920 != cost.dot_bytes


def test_max_samples_spreads_a_long_loop():
    _, _, tprof, cost, tm, tparams, tbatch = forward_profiles("tiny", None)
    counter, _ = count_ops(_logits_fn(tm), tparams, tbatch)
    full = sample_breakdown(counter)
    assert [(label, n) for label, _, n in full] == [
        ("glue", 1), ("scan:layers", 2), ("glue", 1)]
    cut = sample_breakdown(counter, max_samples=1)
    assert [(label, n) for label, _, n in cut] == [
        ("glue", 1), ("scan:layers", 1), ("glue", 1)]
    assert cut[1][1].dot_flops == 2 * full[1][1].dot_flops
    total = OpCost()
    for _, c, n in cut:
        total = total.add(c.scaled(n))
    assert total.dot_flops == cost.dot_flops
    prof = profile_traced(counter, command="port")
    assert [s.to_dict() for s in prof.samples] == \
        [s.to_dict() for s in tprof.samples]


def test_inference_mode_counts_what_autograd_mode_counts():
    """Where autograd is off, composite ops (``matmul``) reach the counter
    whole: it counts their decomposition, as autograd mode does."""
    _, _, tprof, cost, tm, tparams, tbatch = forward_profiles("tiny", None)

    def fn(params, batch):
        with torch.inference_mode():
            return _logits_fn(tm)(params, batch)

    iprof, icost = profile_step(fn, tparams, tbatch, command="port",
                                device="cpu")
    assert icost == cost
    assert [s.to_dict() for s in iprof.samples] == \
        [s.to_dict() for s in tprof.samples]


def test_markers_are_identity_without_a_counter():
    x = torch.ones(3)
    assert op_analysis.open_trip(x, "layers") is x
    assert op_analysis.close_trip(x, "layers") is x
    assert op_analysis.active_counter() is None


def test_mesh_lands_in_sysinfo():
    mesh = make_mesh((2,), ("data",), device="cpu")
    prof, _ = profile_step(torch.add, torch.ones(4), 1.0, command="m",
                           mesh=mesh, device="cpu")
    assert prof.sysinfo == {"backend": "torch-static",
                            "mesh": {"data": 2}, "n_devices": 2}
    assert prof.samples[0].resources.flops == 4


# ---------------------------------------------------------------------------
# ring model and attribution
# ---------------------------------------------------------------------------

MESHES = [{"data": 1}, {"data": 2}, {"data": 4, "model": 2}]


@pytest.mark.parametrize("mesh", MESHES, ids=["1", "2", "4x2"])
@pytest.mark.parametrize("kind", hlo_analysis.COLLECTIVE_BASES)
def test_ring_model_and_attribution_match_the_walker(kind, mesh):
    sizes = list(mesh.values())
    strides, s = [], 1
    for size in reversed(sizes):
        strides.insert(0, s)
        s *= size
    groups = [(size, stride) for size, stride in zip(sizes, strides)]
    groups += [(s, 1), (3, 5)]       # the whole mesh; no axis at all
    ported, ref = [], []
    for i, (size, stride) in enumerate(groups):
        out_bytes = 1024.0 * (i + 1)
        wire = op_analysis._collective_wire_bytes(kind, out_bytes, size)
        assert wire == hlo_analysis._collective_wire_bytes(kind, out_bytes,
                                                           size)
        ported.append(CollectiveOp(kind, wire, size, stride, 2.0))
        ref.append(hlo_analysis.CollectiveOp(kind, wire, size, stride, 2.0))
    got = OpCost(collectives=ported)
    want = hlo_analysis.HloCost(collectives=ref)
    assert attribute_axes(got, mesh) == hlo_analysis.attribute_axes(want,
                                                                     mesh)
    assert got.collective_bytes() == want.collective_bytes()
    assert got.collective_total == want.collective_total
    assert got.scaled(3.0).collective_total == \
        want.scaled(3.0).collective_total


def _collectives_on_a_group(rank, store, queue):
    """One of two gloo ranks: the four functional collectives under the
    counter; puts (rank, [(kind, wire bytes, group size, stride)])."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=2, rank=rank)
    try:
        x = torch.ones(8, 4)
        world = dist.group.WORLD

        def fn():
            return [funcol.all_reduce(x, "sum", world) + 0,
                    funcol.all_gather_single(x, 0, world) + 0
                    if hasattr(funcol, "all_gather_single")
                    else funcol.all_gather_tensor(x, 0, world) + 0,
                    funcol.reduce_scatter_tensor(x, "sum", 0, world) + 0,
                    funcol.all_to_all_single(x, None, None, world) + 0]

        counter, _ = count_ops(fn)
        queue.put((rank, [(c.kind, c.wire_bytes, c.group_size, c.stride)
                          for c in counter.total.collectives]))
    finally:
        dist.destroy_process_group()


def test_functional_collectives_are_charged_the_ring_model(tmp_path):
    """On a 2-rank gloo group the four functional collectives are charged
    the walker's ring-model wire bytes of their results (8 x 4 float32)."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_collectives_on_a_group,
                         args=(r, str(tmp_path / "store"), queue))
             for r in range(2)]
    for p in procs:
        p.start()
    got = dict(queue.get(timeout=120) for _ in procs)
    for p in procs:
        p.join(timeout=60)
        assert not p.is_alive() and p.exitcode == 0
    out = 8 * 4 * 4.0
    want = [("all-reduce", hlo_analysis._collective_wire_bytes(
                "all-reduce", out, 2), 2, 1),
            ("all-gather", hlo_analysis._collective_wire_bytes(
                "all-gather", 2 * out, 2), 2, 1),
            ("reduce-scatter", hlo_analysis._collective_wire_bytes(
                "reduce-scatter", out / 2, 2), 2, 1),
            ("all-to-all", hlo_analysis._collective_wire_bytes(
                "all-to-all", out, 2), 2, 1)]
    assert got == {0: want, 1: want}


# ---------------------------------------------------------------------------
# the flash kernel's custom op
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 8)])
def test_flash_custom_op_is_charged_its_pairs(device, causal, window):
    rng = np.random.default_rng(1)
    BH, BKV, Sq, hd = 4, 2, 32, 16

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(device)

    q, k, v = t(BH, Sq, hd), t(BKV, Sq, hd), t(BKV, Sq, hd)
    launches = fa_kernel.launches
    counter, out = count_ops(
        lambda: fa_kernel.flash_attention(q, k, v, causal=causal,
                                          window=window, group=2))
    cost = counter.total
    assert fa_kernel.launches == launches     # the CPU and meta launch none
    assert out.shape == q.shape and out.device == q.device
    want = fa_ref.flops(BH, Sq, Sq, hd, causal=causal, window=window)
    assert cost.flops == cost.dot_flops == want
    assert cost.dot_bytes == 4.0 * (2 * BH * Sq * hd + 2 * BKV * Sq * hd)
    assert cost.op_flops == {"synapse.flash_attention": want}
    if device == "cpu":
        np.testing.assert_allclose(
            out.numpy(), fa_ref.flash_attention(q, k, v, causal=causal,
                                                window=window,
                                                group=2).numpy(),
            rtol=0, atol=0)

"""The port's dry-run (``repro_torch.launch.dryrun``): a cell's step run
once on DTensors with meta shards over a fake process group, under the
operator counter.

The JAX package's dry-run forces 256 or 512 host devices and fails under
this environment's JAX (``tests/test_system.py::test_dryrun_cell_end_to_end``),
so these tests hold the port's counts to what they must be: on a 1 x 1
mesh, exactly the plain step's counts on meta tensors; on a data-only
mesh, the ring model's bytes for the gradients, computed by hand; in a
decode cell, wire bytes below the local cache; and the artifact keeps the
JAX package's keys, which its ``from_dryrun_artifact`` reads.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core.predictor import from_dryrun_artifact as j_from_artifact
from repro_torch.configs import SHAPES, get_config, reduced_config
from repro_torch.configs.run import for_shape
from repro_torch.core import op_analysis
from repro_torch.core.predictor import from_dryrun_artifact
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import close_fake_world, fake_device_mesh
from repro_torch.models.layers import attend_blocked
from repro_torch.models import ssm
from repro_torch.models.model_zoo import build_model
from repro_torch.models.params import map_tensors
from repro_torch.parallel.sharding import TRAIN_RULES, make_rules
from repro_torch.train.step import abstract_train_state, train_state_specs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the JAX package's artifact (src/repro/launch/dryrun.py: run_cell and
# analyze), less "xla_cost", XLA's own cost analysis
REFERENCE_KEYS = {"arch", "shape", "mesh_tag", "tag", "ok", "run_config",
                  "lower_s", "compile_s", "params", "active_params",
                  "model_flops", "n_devices", "mesh", "memory", "walker",
                  "useful_flops_ratio"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes",
               "alias_bytes", "code_bytes", "per_device_total"}
WALKER_KEYS = {"flops", "transcendentals", "hbm_bytes", "dot_bytes",
               "collective_bytes", "collective_total", "collective_by_axis",
               "analysis_s", "top_ops"}


@pytest.fixture(autouse=True, scope="module")
def _no_fake_world_after():
    yield
    close_fake_world()


def _cell(kind, seq=64, batch=2, **run_kw):
    """A reduced cell of ``kind``: its shape and run config (blocks small
    enough that a 64-token train step takes the blocked attention)."""
    shape = dataclasses.replace(
        {"train": SHAPES["train_4k"], "prefill": SHAPES["prefill_32k"],
         "decode": SHAPES["decode_32k"]}[kind], seq_len=seq,
        global_batch=batch)
    run = dataclasses.replace(dryrun._run_config(shape), **{
        "loss_chunk": 16, "block_q": 16, "block_kv": 32,
        "blocked_threshold": 32, **run_kw})
    return shape, run


# ---------------------------------------------------------------------------
# identical trips: blocked attention's loops on meta tensors
# ---------------------------------------------------------------------------

ATTN_CASES = [  # B, S, Hk, G, hd, block_q, block_kv, window, causal
    (2, 64, 2, 2, 8, 16, 32, None, True),
    (2, 64, 2, 2, 8, 16, 32, None, False),
    (1, 96, 2, 3, 16, 32, 32, 20, True),      # the banded path, 3 blocks
    (1, 96, 2, 3, 16, 32, 32, 20, False),
    (1, 128, 1, 2, 8, 16, 16, 8, True),
    (2, 64, 2, 2, 8, 64, 64, None, True),     # one block: no shortcut
]


@pytest.mark.parametrize("case", ATTN_CASES)
def test_blocked_attention_on_meta_counts_every_trip(case):
    """On meta tensors under the counter, a loop of identical trips runs
    two and counts them for all; every count and the peak of live bytes
    equal the full loops' on CPU tensors."""
    B, S, Hk, G, hd, bq, bk, win, causal = case
    g = torch.Generator().manual_seed(0)
    q = torch.randn(B, S, Hk, G, hd, generator=g, requires_grad=True)
    k = torch.randn(B, S, Hk, hd, generator=g, requires_grad=True)
    v = torch.randn(B, S, Hk, hd, generator=g, requires_grad=True)

    def run(q, k, v):
        o = attend_blocked(q, k, v, causal=causal, window=win, softcap=30.0,
                           block_q=bq, block_kv=bk)
        return torch.autograd.grad(o.square().sum(), (q, k, v))

    cpu, _ = op_analysis.count_ops(run, q, k, v)
    meta, _ = op_analysis.count_ops(
        run, *(t.detach().to("meta").requires_grad_() for t in (q, k, v)))
    assert meta.total == cpu.total
    assert meta.peak_live_bytes == cpu.peak_live_bytes


def test_identical_trips_runs_every_trip_off_meta_and_without_a_counter():
    x = torch.zeros(2)
    with op_analysis.identical_trips(7, x) as n:
        assert n == 7
    m = x.to("meta")
    with op_analysis.identical_trips(7, m) as n:
        assert n == 7                                # no counter
    with op_analysis.OpCounter() as c:
        with op_analysis.identical_trips(7, m) as n:
            assert n == 2
            with op_analysis.identical_trips(3, m) as n2:
                assert n2 == 2
                m + 1
        m + 1
    assert c.total.flops == 7 / 2 * 3 / 2 * 2 + 2


# ---------------------------------------------------------------------------
# abstract parameters and state
# ---------------------------------------------------------------------------

def test_abstract_params_and_state_have_no_data():
    model = build_model(get_config("qwen2-7b"), for_shape("train"))
    params = model.abstract()
    assert params["embed"].is_meta and params["embed"].dtype == torch.float32
    assert tuple(params["embed"].shape) == (152064, 3584)
    state = abstract_train_state(model)
    assert state["opt"]["step"].dtype == torch.int32
    assert state["opt"]["mu"]["embed"].is_meta
    mesh = fake_device_mesh((16, 16), ("data", "model"))
    rules = make_rules(mesh, TRAIN_RULES)
    dstate = abstract_train_state(model, mesh, rules)
    specs = train_state_specs(model, mesh, rules)

    def shards(e):             # every axis of this mesh has 16 devices
        return 1 if e is None else 16 ** (len(e) if isinstance(e, tuple)
                                           else 1)

    def check(t, spec):
        local = t.to_local()
        assert local.is_meta
        spec = tuple(spec) + (None,) * (t.dim() - len(spec))
        assert tuple(local.shape) == tuple(
            d // shards(e) for d, e in zip(t.shape, spec))
        return t
    map_tensors(dstate["params"], check, specs["params"])
    map_tensors(dstate["opt"]["mu"], check, specs["opt"]["mu"])
    # the embedding: vocab over 'model', d_model over 'data' (FSDP); its
    # moments too (ZeRO-1 finds 'data' taken)
    assert tuple(dstate["params"]["embed"].to_local().shape) == (9504, 224)


# ---------------------------------------------------------------------------
# the counts of a sharded step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen2-7b", "gemma2-2b", "mamba2-780m",
                                  "hymba-1.5b"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_one_by_one_mesh_counts_what_the_plain_step_counts(kind, arch):
    """On a 1 x 1 fake mesh the DTensor step counts exactly what the same
    step counts on plain meta tensors: flops, transcendentals, bytes, the
    peak of live bytes, arguments and outputs: the sharded and the plain
    step run one program.  The SSM families too, whose scan and decode
    update (with their ``softplus``, which DTensor would decompose) run
    through ``shard_local``."""
    cfg = reduced_config(get_config(arch))
    shape, run = _cell(kind)
    mesh = fake_device_mesh((1, 1), ("data", "model"))
    low, meta = dryrun.lower_cell(cfg, shape, mesh, run)
    plain = dryrun._count_run(*dryrun.cell_step(cfg, shape, None, run)[:3])
    assert low.cost.collective_total == 0
    assert low.argument_bytes == plain.argument_bytes
    assert low.output_bytes == plain.output_bytes
    for f in ("flops", "transcendentals", "hbm_bytes", "dot_bytes",
              "dot_flops"):
        assert getattr(low.cost, f) == getattr(plain.cost, f), f
    assert low.peak_live_bytes == plain.peak_live_bytes
    rec = dryrun.analyze(low, mesh, meta)
    assert rec["n_devices"] == 1 and rec["mesh"] == {"data": 1, "model": 1}
    assert rec["mesh_device_type"] == mesh.device_type


def test_data_parallel_gradients_move_the_ring_models_bytes():
    """A 2 x 1 mesh, data only: the parameters are replicated (the reduced
    config's leaves are below the FSDP threshold) and ZeRO-1 shards each
    moment over 'data', so the step reduce-scatters each float32 gradient
    ((n - 1) x its shard: half its bytes) and all-gathers each update
    (half its bytes), by the walker's ring model; the one all-reduce left
    is the gradient norm's partial sum."""
    cfg = reduced_config(get_config("qwen2-7b"))
    shape, run = _cell("train", seq=32, batch=4, loss_chunk=0)
    mesh = fake_device_mesh((2, 1), ("data", "model"))
    low, _ = dryrun.lower_cell(cfg, shape, mesh, run)
    model = build_model(cfg, run)
    specs = train_state_specs(model, mesh, make_rules(mesh, TRAIN_RULES))
    # 'model' has one device: the parameters are replicated
    assert all(e in (None, "model") for _, s in _flat(specs["params"])
               for e in s)
    half = sum(p.numel() * 4 / 2 for p in _leaves(model.abstract()))
    assert all("data" in s for _, s in _flat(specs["opt"]["mu"]))
    assert low.cost.collective_bytes() == {
        "reduce-scatter": half, "all-gather": half, "all-reduce": 4.0}
    assert dryrun.analyze(low, mesh, {"model_flops": 1.0})["walker"][
        "collective_by_axis"] == {"data": 2 * half + 4.0}


def test_decode_moves_less_than_its_local_cache():
    """The cache is sharded along its length ('cache_seq' on 'model'): a
    decode step that gathered it would move at least its local bytes."""
    cfg = reduced_config(get_config("qwen2-7b"))
    shape, run = _cell("decode", seq=256, batch=4)
    mesh = fake_device_mesh((2, 4), ("data", "model"))
    low, meta = dryrun.lower_cell(cfg, shape, mesh, run)
    step, args, donated, _ = dryrun.cell_step(cfg, shape, mesh, run)
    cache = args[2]["attn"]
    assert [p.dim for p in cache["k"].placements] == [1, 2]
    local_cache = dryrun.tree_bytes(cache)
    assert low.alias_bytes == local_cache
    assert 0 < low.cost.collective_total < local_cache
    rec = dryrun.analyze(low, mesh, meta)
    assert rec["memory"]["per_device_total"] == \
        rec["memory"]["argument_bytes"] + low.peak_live_bytes


# ---------------------------------------------------------------------------
# Mamba-2: the scan and the decode update on each device's shards
# ---------------------------------------------------------------------------

def _recorded(monkeypatch, name, calls):
    """``ssm.<name>`` wrapped to append, a call, what it added to the
    active counter: (flops, collectives, its tensor arguments' dtypes,
    its keyword arguments)."""
    inner = getattr(ssm, name)

    def counted(*a, **kw):
        c = op_analysis.active_counter()
        before = c.total
        out = inner(*a, **kw)
        after = c.total
        calls.append((after.flops - before.flops,
                      after.collectives[len(before.collectives):],
                      [t.dtype for t in a if isinstance(t, torch.Tensor)],
                      kw))
        return out
    monkeypatch.setattr(ssm, name, counted)
    return inner


def _model_gathers(collectives, model: int = 4) -> float:
    """The wire bytes of the all-gathers along 'model' (the last axis of
    a (data, model) mesh: groups of ``model`` ranks at stride 1)."""
    return sum(c.total_bytes for c in collectives
               if c.kind == "all-gather" and
               (c.group_size, c.stride) == (model, 1))


def test_mamba2_scan_counts_one_devices_share(monkeypatch):
    """On a 2 x 4 mesh each counted scan is one device's share: its flops
    equal those of the plain ``ssd_chunked`` counted on meta tensors of
    one device's shapes (half the batch rows, a quarter of the heads),
    and it issues no collective."""
    cfg = reduced_config(get_config("mamba2-780m"))
    shape, run = _cell("prefill", seq=32, batch=4)
    mesh = fake_device_mesh((2, 4), ("data", "model"), "cpu")
    calls = []
    plain = _recorded(monkeypatch, "ssd_chunked", calls)
    dryrun.lower_cell(cfg, shape, mesh, run)
    B, S, H, P = 4 // 2, 32, cfg.ssm_heads // 4, cfg.ssm.head_dim
    G, N = cfg.ssm.ngroups, cfg.ssm.state_dim
    assert len(calls) == cfg.num_layers
    for flops, colls, (xd, dd, ad, bd, cd), kw in calls:
        want = op_analysis.analyze(
            plain, *(torch.empty(s, dtype=d, device="meta") for s, d in (
                ((B, S, H, P), xd), ((B, S, H), dd), ((H,), ad),
                ((B, S, G, N), bd), ((B, S, G, N), cd))), **kw)
        assert flops == pytest.approx(want.flops, rel=1e-9, abs=0)
        assert colls == []


def test_mamba2_block_gathers_along_model_only_the_residual_and_the_splits(
        monkeypatch):
    """What a Mamba-2 block all-gathers along 'model' on a 2 x 4 mesh, a
    device's bytes by the ring model ((m - 1) / m of the gathered local
    tensor): in prefill, the residual stream's sequence-parallel gather
    before ``in_proj``, the gathers of the two splits whose column shards
    do not line up with the heads (``in_proj``'s output into z, x, B, C
    and dt; the convolution's into x, B and C: GSPMD must move these
    bytes too), and the gated norm's
    per-row statistic; in decode, the two splits.  Nothing else: the scan
    and the decode update gather neither heads nor the cache's state."""
    cfg = reduced_config(get_config("mamba2-780m"))
    di, H = cfg.d_inner, cfg.ssm_heads
    GN = cfg.ssm.ngroups * cfg.ssm.state_dim
    mesh = fake_device_mesh((2, 4), ("data", "model"), "cpu")
    for kind, S in (("prefill", 32), ("decode", 1)):
        shape, run = _cell(kind, seq=32, batch=4)
        calls = []
        _recorded(monkeypatch, "mamba2_block", calls)
        dryrun.lower_cell(cfg, shape, mesh, run)
        monkeypatch.undo()
        rows = 2 * S * 3 / 4                   # a device's rows, (m - 1) / m
        item = torch.empty((), dtype=run.cdtype).element_size()
        splits = rows * item * ((2 * di + 2 * GN + H) + (di + 2 * GN))
        want = splits + rows * (item * cfg.d_model + 4) \
            if kind == "prefill" else splits
        assert len(calls) == cfg.num_layers
        for _, colls, _, _ in calls:
            assert _model_gathers(colls) == want, kind


def test_a_dense_cells_counts_stay_put():
    """The scan's repair leaves the dense family alone: a reduced
    Qwen2-7B cell of each kind on a 2 x 4 mesh counts what it counted
    before the Mamba-2 scan ran on local shards (flops,
    transcendentals, HBM and dot bytes, wire bytes by kind, the peak of
    live bytes and the argument bytes)."""
    cfg = reduced_config(get_config("qwen2-7b"))
    mesh = fake_device_mesh((2, 4), ("data", "model"), "cpu")
    for kind, want in DENSE_COUNTS.items():
        shape, run = _cell(kind, seq=64, batch=4)
        low, _ = dryrun.lower_cell(cfg, shape, mesh, run)
        c = low.cost
        assert (c.flops, c.transcendentals, c.hbm_bytes, c.dot_bytes,
                c.collective_bytes(), low.peak_live_bytes,
                low.argument_bytes) == want, kind


# the reduced Qwen2-7B cells of _cell(kind, seq=64, batch=4) on a 2 x 4
# "cpu" mesh, as the dense path counted them before the Mamba-2 scan ran
# on local shards
DENSE_COUNTS = {
    "train": (38042255.0, 141394.0, 23967434.0, 3204096.0,
              {"reduce-scatter": 351808.0, "all-gather": 582976.0,
               "all-reduce": 3274.0}, 372844.0, 267012),
    "prefill": (7709856.0, 41888.0, 4821116.0, 631296.0,
                {"reduce-scatter": 61440.0, "all-gather": 135168.0,
                 "all-reduce": 6.0}, 115280.0, 67008),
    "decode": (140370.0, 522.0, 258394.0, 78336.0,
               {"all-reduce": 2118.0, "all-gather": 384.0,
                "reduce-scatter": 384.0}, 10256.0, 74712),
}


# ---------------------------------------------------------------------------
# MoE: the router's gradient summed over the devices that split the batch
# ---------------------------------------------------------------------------

# the reduced Moonlight train cell of _cell("train", seq=32, batch=4,
# loss_chunk=0) on a "cpu" mesh, as counted while each device kept its own
# rows' share of the router's gradient: flops, transcendentals, dot bytes,
# wire bytes by mesh axis
MOE_TRAIN_BEFORE = {
    (2, 1): (77357894.0, 244258.0, 4071424.0, {"data": 627092.0}),
    (2, 2): (38924203.0, 131170.0, 2277376.0,
             {"model": 305924.0, "data": 348052.0}),
}


@pytest.mark.parametrize("shape", list(MOE_TRAIN_BEFORE),
                         ids=["2x1", "2x2"])
def test_moe_train_cell_reduces_the_routers_gradient_over_data(shape):
    """Every device routes its own rows with the whole router, so the
    router's gradient is summed over 'data': one all-reduce a layer of
    the router as the step reads it (the compute dtype's [D, E]; 'model'
    splits the sequence, which each device gathers before it routes, so
    the router is whole there), by the walker's ring model 2 (n - 1) / n
    of its bytes.  Nothing else moves: the flops, the dot bytes and the
    other wire are what they were without the sum."""
    cfg = reduced_config(get_config("moonshot-v1-16b-a3b"))
    shape_, run = _cell("train", seq=32, batch=4, loss_chunk=0)
    mesh = fake_device_mesh(shape, ("data", "model"), "cpu")
    low, meta = dryrun.lower_cell(cfg, shape_, mesh, run)
    d, e = cfg.d_model, cfg.moe.num_experts
    item = torch.empty((), dtype=run.cdtype).element_size()
    n = shape[0]
    router = [c for c in low.cost.collectives
              if c.kind == "all-reduce" and c.shape == str((d, e))]
    assert len(router) == cfg.num_layers
    assert all(c.group_size == n and c.stride == shape[1] for c in router)
    each = 2 * (n - 1) / n * d * e * item
    assert all(c.total_bytes == each for c in router)
    flops, trans, dot, wire = MOE_TRAIN_BEFORE[shape]
    c = low.cost
    assert (c.flops, c.transcendentals, c.dot_bytes) == (flops, trans, dot)
    want = dict(wire, data=wire["data"] + cfg.num_layers * each)
    assert dryrun.analyze(low, mesh, meta)["walker"][
        "collective_by_axis"] == want


# ---------------------------------------------------------------------------
# Hymba: both branches laid out as the residual stream before their norms
# ---------------------------------------------------------------------------

def _hybrid_norm_inputs(monkeypatch):
    """``hybrid.rmsnorm`` wrapped to record its input's placements: four
    calls a block (the block input's norm, the attention branch's, the
    SSM branch's, the MLP's)."""
    from repro_torch.models import hybrid
    seen = []
    inner = hybrid.rmsnorm

    def recorded(p, x, eps):
        seen.append(tuple(getattr(x, "placements", ())))
        return inner(p, x, eps)
    monkeypatch.setattr(hybrid, "rmsnorm", recorded)
    return seen


@pytest.mark.parametrize("shape_name", ["long_500k", "decode_32k",
                                        "prefill_32k", "train_4k"])
def test_hymba_branches_reach_their_sum_in_the_residuals_layout(
        shape_name, monkeypatch):
    """On a 2 x 2 mesh under each cell's rules (``LONG_DECODE_RULES`` for
    long_500k, ``DECODE_RULES`` for decode), the attention and SSM
    branches reach their norms and their sum laid out as the block's
    input, the residual stream, with no partial sum left: DTensor has no
    layout to choose there.  Left to choose, it took crossed layouts
    (long_500k at full width: attention (Partial, Shard(2)), the SSM
    (Shard(2), Partial)), and torch 2.11, the card's, refused the
    Shard(2) -> Partial(sum) it then planned.  That refusal shows only
    under torch 2.11, on the card (``chip_smoke.py``'s dry-run phase runs
    Hymba's long_500k); here the layouts are pinned."""
    from torch.distributed.tensor import Partial
    cfg = reduced_config(get_config("hymba-1.5b"))
    shape = dataclasses.replace(
        SHAPES[shape_name], seq_len=64,
        global_batch=1 if shape_name == "long_500k" else 4)
    run = dataclasses.replace(dryrun._run_config(shape), **{
        "loss_chunk": 16, "block_q": 16, "block_kv": 32,
        "blocked_threshold": 32})
    mesh = fake_device_mesh((2, 2), ("data", "model"), "cpu")
    seen = _hybrid_norm_inputs(monkeypatch)
    dryrun.lower_cell(cfg, shape, mesh, run)
    assert seen and len(seen) % 4 == 0
    for i in range(0, len(seen), 4):
        x, attn, ssm_out, _ = seen[i:i + 4]
        assert attn == ssm_out == x, (i, x, attn, ssm_out)
        assert not any(isinstance(p, Partial) for p in x)


def test_hymba_plain_block_is_the_same_computation(monkeypatch):
    """Plain tensors (one device, serving without a mesh) go through the
    branches' lay-out untouched: the very tensors come back, and the
    forward is bit for bit the one without it."""
    from repro_torch.models import hybrid
    from repro_torch.configs.run import RunConfig
    cfg = reduced_config(get_config("hymba-1.5b"))
    model = build_model(cfg, RunConfig(param_dtype="float32",
                                       compute_dtype="float32"))
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 24)).astype(np.int32))
    laid = hybrid.match_placements
    same = []

    def recorded(t, like):
        out = laid(t, like)
        same.append(out is t)
        return out
    monkeypatch.setattr(hybrid, "match_placements", recorded)
    got = model.forward(params, {"tokens": toks})[0]
    assert same and all(same)
    monkeypatch.setattr(hybrid, "match_placements", lambda t, like: t)
    want = model.forward(params, {"tokens": toks})[0]
    assert torch.equal(got, want)


def test_groups_of_a_devices_heads():
    """B and C's groups that a device's heads read: one group for heads
    inside it, several whole ones, and a refusal where the heads would
    split groups unevenly (the scan repeats each group alike)."""
    assert ssm._groups_of(0, 8, 8, 1) == slice(0, 1)
    assert ssm._groups_of(6, 2, 8, 1) == slice(0, 1)
    assert ssm._groups_of(4, 4, 8, 4) == slice(2, 4)
    assert ssm._groups_of(2, 1, 8, 8) == slice(2, 3)
    with pytest.raises(ValueError, match="unevenly"):
        ssm._groups_of(0, 6, 12, 3)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], path + (k,))
    else:
        yield path, tuple(tree)


# ---------------------------------------------------------------------------
# the command line and the artifact
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cli_artifacts(tmp_path_factory):
    """The CLI on the JAX package's own test cell, qwen2-1.5b decode_32k at
    16 x 16, and on a cell that is not runnable; no card, no XLA flags."""
    out = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("XLA_FLAGS", None)
    runs = []
    for shape in ("decode_32k", "long_500k"):
        runs.append(subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             "qwen2-1.5b", "--shape", shape, "--out", str(out)],
            env=env, capture_output=True, text=True, timeout=300))
    again = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen2-1.5b", "--shape", "decode_32k", "--out", str(out),
         "--skip-existing"],
        env=env, capture_output=True, text=True, timeout=300)
    return out, runs, again


def test_cli_decode_cell_end_to_end(cli_artifacts):
    out, runs, _ = cli_artifacts
    assert runs[0].returncode == 0, runs[0].stderr[-2000:]
    assert "qwen2-1.5b__decode_32k__16x16: ok" in runs[0].stdout
    rec = json.load(open(out / "qwen2-1.5b__decode_32k__16x16.json"))
    assert rec["ok"] and rec["n_devices"] == 256
    assert rec["mesh"] == {"data": 16, "model": 16}
    assert rec["memory"]["per_device_total"] < 80e9
    assert rec["walker"]["flops"] > 0
    assert rec["walker"]["collective_total"] > 0
    assert rec["memory"]["alias_bytes"] > 0          # the donated cache


def test_artifact_has_the_reference_keys_and_reads_in_both_packages(
        cli_artifacts):
    out, _, _ = cli_artifacts
    rec = json.load(open(out / "qwen2-1.5b__decode_32k__16x16.json"))
    # and the fake mesh's device type, which DTensor lays some steps by
    assert set(rec) == REFERENCE_KEYS | {"mesh_device_type"}
    assert rec["mesh_device_type"] == ("cuda" if torch.cuda.is_available()
                                       else "cpu")
    assert set(rec["memory"]) == MEMORY_KEYS
    assert set(rec["walker"]) == WALKER_KEYS
    m = rec["memory"]
    assert m["per_device_total"] == (m["argument_bytes"] + m["output_bytes"]
                                     + m["temp_bytes"] - m["alias_bytes"])
    ours, theirs = from_dryrun_artifact(rec), j_from_artifact(rec)
    assert ours.to_dict() == theirs.to_dict()
    assert ours.flops == rec["walker"]["flops"]
    assert ours.hbm_bytes == rec["walker"]["dot_bytes"]
    assert sum(ours.ici_bytes.values()) == rec["walker"]["collective_total"]


def test_cli_writes_skip_records_and_skips_existing(cli_artifacts):
    out, runs, again = cli_artifacts
    assert runs[1].returncode == 0, runs[1].stderr[-2000:]
    rec = json.load(open(out / "qwen2-1.5b__long_500k__16x16.json"))
    assert rec["ok"] and rec["skipped"]
    assert "sub-quadratic" in rec["skip_reason"]
    assert again.returncode == 0
    assert "[skip] qwen2-1.5b__decode_32k__16x16" in again.stdout


def test_a_failing_cell_records_its_error_and_the_sweep_goes_on(
        tmp_path, monkeypatch, capsys):
    def broken(*a, **k):
        raise RuntimeError("no strategy for this op")
    monkeypatch.setattr(dryrun, "lower_cell", broken)
    dryrun.main(["--arch", "qwen2-7b", "--shape", "decode_32k", "--out",
                 str(tmp_path), "--tag", "t", "--mesh-device", "cpu"])
    dryrun.main(["--arch", "qwen2-7b", "--shape", "long_500k", "--out",
                 str(tmp_path)])
    rec = json.load(open(tmp_path / "qwen2-7b__decode_32k__16x16__t.json"))
    assert rec["ok"] is False and rec["tag"] == "t"
    assert rec["error"] == "RuntimeError: no strategy for this op"
    assert "broken" in rec["traceback"]
    assert json.load(open(tmp_path / "qwen2-7b__long_500k__16x16.json"))[
        "skipped"]
    printed = capsys.readouterr().out
    assert "FAIL RuntimeError" in printed and "SKIP(" in printed


def test_overrides_reach_the_run_config(tmp_path):
    rec = dryrun.run_cell("qwen2-1.5b", "long_500k", False, str(tmp_path),
                          overrides={"remat": "none"})
    assert rec["skipped"]                      # decided before the config
    shape = SHAPES["train_4k"]
    run = dryrun._run_config(shape, {"remat": "none", "zero1": False},
                             arch="qwen2-72b")
    assert (run.remat, run.zero1, run.microbatches) == ("none", False, 4)
    assert dryrun._run_config(SHAPES["decode_32k"], arch="qwen2-72b") \
        .microbatches == 1

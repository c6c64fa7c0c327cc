"""The port's sharding against the JAX package's: rule tables, ``Rules``,
spec trees, abstract inputs, the run config and the dense path's
``shard`` sites.

The JAX package needs a mesh for some of these.  None of these tests makes
256 JAX devices: its ``Rules`` are built directly from a table, axes and
sizes; where its functions read a mesh, they get ``_JMesh``, which holds
what they read (``axis_names``, ``devices.shape``, ``shape``), and its
``NamedSharding``s are made on a ``jax.sharding.AbstractMesh`` of the same
shape.  The port's DTensors live on fake process groups of as many ranks
as a mesh has (``launch.mesh.fake_device_mesh``), with meta shards.
"""
import ast
import dataclasses
import os
import pickle

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import NamedSharding as JNamedSharding

from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.configs import reduced_config as j_reduced
from repro.configs.run import RunConfig as JRun
from repro.configs.run import for_shape as j_for_shape
from repro.launch import specs as j_specs
from repro.models import layers as j_layers
from repro.models import transformer as j_transformer
from repro.models.model_zoo import build_model as j_build
from repro.models.params import is_pdef as j_is_pdef
from repro.optim.adamw import zero1_specs as j_zero1
from repro.parallel import sharding as js
from repro.train.step import train_state_specs as j_state_specs
from repro_torch.configs import (SHAPES, cell_is_runnable, get_config,
                                 list_archs, reduced_config)
from repro_torch.configs.run import RunConfig, for_shape
from repro_torch.launch import specs
from repro_torch.launch.mesh import (Mesh, close_fake_world, describe,
                                     fake_device_mesh, fake_device_type,
                                     make_production_mesh)
from repro_torch.models import layers as t_layers
from repro_torch.models import transformer as t_transformer
from repro_torch.models.model_zoo import build_model
from repro_torch.models.params import from_numpy, is_pdef
from repro_torch.optim.adamw import zero1_specs
from repro_torch.parallel import sharding as ts
from repro_torch.train.step import train_state_specs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TABLES = ("TRAIN_RULES", "PREFILL_RULES", "DECODE_RULES",
          "LONG_DECODE_RULES", "FSDP_RULES")
# the production meshes, and one whose model axis (8) leaves 16 of
# Llama-4's 40 heads over: it reaches the row-parallel fallback
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "4x8": ((4, 8), ("data", "model"))}
ARCHS = list_archs()
RUNNABLE = [(a, s) for a in ARCHS for s in SHAPES
            if cell_is_runnable(get_config(a), SHAPES[s])[0]]


class _JMesh:
    """What the JAX package's sharding code reads of a mesh."""

    def __init__(self, shape, axes):
        self.axis_names = tuple(axes)
        self.devices = np.empty(shape)
        self.shape = dict(zip(axes, shape))


@pytest.fixture(autouse=True, scope="module")
def _no_fake_world_after():
    yield
    close_fake_world()


def _rules(table_name, mesh_name):
    shape, axes = MESHES[mesh_name]
    sizes = dict(zip(axes, shape))
    return (js.Rules(getattr(js, table_name), axes, sizes),
            ts.Rules(getattr(ts, table_name), axes, sizes))


def _pdef_leaves(tree, is_leaf, path=()):
    if is_leaf(tree):
        yield path, tree
        return
    for k in sorted(tree):
        yield from _pdef_leaves(tree[k], is_leaf, path + (k,))


def _spec_leaves(tree, path=()):
    """(path, spec as a tuple) of a spec tree of either package."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _spec_leaves(tree[k], path + (k,))
    else:
        yield path, tuple(tree)


def _models(arch, **run_kw):
    return (j_build(j_get_config(arch), JRun(**run_kw)),
            build_model(get_config(arch), RunConfig(**run_kw)))


# ---------------------------------------------------------------------------
# tables and rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", TABLES)
def test_rule_tables_are_the_reference_letter_for_letter(name):
    assert getattr(ts, name) == getattr(js, name)
    assert list(getattr(ts, name)) == list(getattr(js, name))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("table", TABLES)
def test_rules_agree_on_every_logical_axis_and_pdef(table, mesh_name):
    jr, tr = _rules(table, mesh_name)
    for logical in list(getattr(js, table)) + [None]:
        r = tr.resolve(logical)
        assert r == jr.resolve(logical), logical
        assert tr.axis_size(r) == jr.axis_size(r), logical
    assert tuple(tr.pspec("batch", "seq", "embed")) == \
        tuple(jr.pspec("batch", "seq", "embed"))
    with pytest.raises(KeyError):
        tr.resolve("no_such_axis")
    fell_back = 0
    for arch in ARCHS:
        jm, tm = _models(arch)
        jl = list(_pdef_leaves(jm.pdefs, j_is_pdef))
        tl = list(_pdef_leaves(tm.pdefs, is_pdef))
        assert [p for p, _ in jl] == [p for p, _ in tl], arch
        for (path, jp), (_, tp) in zip(jl, tl):
            assert (tp.shape, tp.axes) == (jp.shape, jp.axes), (arch, path)
            for fb in (False, True):
                want = tuple(jr.pspec_checked(jp.shape, jp.axes,
                                              tp_fallback=fb))
                got = tr.pspec_checked(tp.shape, tp.axes, tp_fallback=fb)
                assert isinstance(got, ts.PartitionSpec)
                assert tuple(got) == want, (arch, path, fb)
            plain = tuple(tr.pspec_checked(tp.shape, tp.axes))
            fb_spec = tuple(tr.pspec_checked(tp.shape, tp.axes,
                                             tp_fallback=True))
            fell_back += "model" not in plain and "model" in fb_spec
    if table != "FSDP_RULES":
        # row-parallel fallback: d_model takes 'model' where heads cannot
        assert fell_back > 0


def test_partition_spec_is_a_tuple_that_pickles():
    spec = ts.P(("data",), None, ("pod", "data"))
    assert tuple(spec) == ("data", None, ("pod", "data")) == \
        tuple(jax.sharding.PartitionSpec(("data",), None, ("pod", "data")))
    assert pickle.loads(pickle.dumps(spec)) == spec
    assert repr(spec) == "PartitionSpec('data', None, ('pod', 'data'))"


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_batch_axis_size_and_named_sharding(mesh_name):
    shape, axes = MESHES[mesh_name]
    mesh = Mesh(shape, axes, "cpu")
    for table in TABLES:
        assert ts.batch_axis_size(mesh, getattr(ts, table)) == \
            js.batch_axis_size(_JMesh(shape, axes), getattr(js, table))
    assert ts.batch_axis_size(None) == 1
    assert ts.named_sharding("batch") is None
    with ts.use_sharding(mesh, ts.TRAIN_RULES) as ctx:
        assert ts.current_ctx() is ctx
        ns = ts.named_sharding("batch", "seq", "vocab")
        assert ns.mesh is mesh
        want = js.Rules(js.TRAIN_RULES, axes, dict(zip(axes, shape))).pspec(
            "batch", "seq", "vocab")
        assert tuple(ns.spec) == tuple(want)
    assert ts.current_ctx() is None


# ---------------------------------------------------------------------------
# spec trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_name", ["16x16", "2x16x16"])
@pytest.mark.parametrize("mode", ["megatron", "fsdp"])
def test_spec_trees_match_leaf_for_leaf(mode, mesh_name):
    shape, axes = MESHES[mesh_name]
    table = "FSDP_RULES" if mode == "fsdp" else "TRAIN_RULES"
    jr, tr = _rules(table, mesh_name)
    jmesh, tmesh = _JMesh(shape, axes), Mesh(shape, axes, "cpu")
    for arch in ARCHS:
        jm, tm = _models(arch, sharding_mode=mode)
        jp, tp = jm.param_specs(jr), tm.param_specs(tr)
        assert list(_spec_leaves(tp)) == list(_spec_leaves(jp)), arch
        assert list(_spec_leaves(zero1_specs(tp, tm.abstract(), tmesh,
                                             tr))) == \
            list(_spec_leaves(j_zero1(jp, jm.abstract(), jmesh, jr))), arch
        assert list(_spec_leaves(train_state_specs(tm, tmesh, tr))) == \
            list(_spec_leaves(j_state_specs(jm, jmesh, jr))), arch


def test_zero1_off_keeps_the_parameters_specs():
    shape, axes = MESHES["16x16"]
    jr, tr = _rules("TRAIN_RULES", "16x16")
    jm, tm = _models("qwen2-7b", zero1=False)
    tspecs = train_state_specs(tm, Mesh(shape, axes, "cpu"), tr)
    assert list(_spec_leaves(tspecs)) == list(_spec_leaves(
        j_state_specs(jm, _JMesh(shape, axes), jr)))
    assert list(_spec_leaves(tspecs["opt"]["mu"])) == \
        list(_spec_leaves(tspecs["params"]))


# ---------------------------------------------------------------------------
# abstract inputs
# ---------------------------------------------------------------------------

def _j_named(mesh, spec):
    return JNamedSharding(AbstractMesh(mesh.devices.shape, mesh.axis_names),
                          spec)


def _leaves_with_paths(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_paths(tree[k], path + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves_with_paths(v, path + (i,))
    else:
        yield path, tree


@pytest.mark.parametrize("arch,shape_name", RUNNABLE,
                         ids=[f"{a}-{s}" for a, s in RUNNABLE])
def test_input_specs_match_the_reference(arch, shape_name, monkeypatch):
    monkeypatch.setattr(j_specs, "NamedSharding", _j_named)
    shape_, axes = MESHES["16x16"]
    mesh = fake_device_mesh(shape_, axes)
    jin = j_specs.input_specs(j_get_config(arch), J_SHAPES[shape_name],
                              _JMesh(shape_, axes),
                              j_for_shape(J_SHAPES[shape_name].kind))
    tin = specs.input_specs(get_config(arch), SHAPES[shape_name], mesh,
                            for_shape(SHAPES[shape_name].kind))
    jl, tl = list(_leaves_with_paths(jin)), list(_leaves_with_paths(tin))
    assert [p for p, _ in tl] == [p for p, _ in jl]
    for (path, j), (_, t) in zip(jl, tl):
        assert isinstance(t, torch.distributed.tensor.DTensor), path
        assert tuple(t.shape) == tuple(j.shape), path
        assert str(t.dtype).removeprefix("torch.") == str(j.dtype), path
        assert tuple(t.placements) == ts.spec_placements(
            ts.P(*j.sharding.spec), mesh), path
        local = t.to_local()
        assert local.is_meta, path
        assert tuple(local.shape) == j.sharding.shard_shape(j.shape), path


def test_input_specs_without_a_mesh_are_meta_tensors():
    (batch,) = specs.input_specs(get_config("qwen2-7b"), SHAPES["train_4k"],
                                 None, for_shape("train"))
    assert {k: (tuple(v.shape), v.dtype, v.device.type)
            for k, v in batch.items()} == {
        "tokens": ((256, 4096), torch.int32, "meta"),
        "targets": ((256, 4096), torch.int32, "meta")}
    assert specs.rules_table_for(SHAPES["train_4k"],
                                 RunConfig(sharding_mode="fsdp")) is \
        ts.FSDP_RULES
    assert specs.rules_table_for(SHAPES["long_500k"]) is ts.LONG_DECODE_RULES


# ---------------------------------------------------------------------------
# the run config
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_for_shape_matches_the_reference(kind):
    ours, theirs = for_shape(kind), j_for_shape(kind)
    for f in dataclasses.fields(ours):
        assert getattr(ours, f.name) == getattr(theirs, f.name), f.name
    with pytest.raises(ValueError, match="sharding_mode"):
        RunConfig(sharding_mode="zero3")


def test_train_microbatches_match_the_reference():
    """The JAX package's dry-run module forces host devices when imported,
    so its table is read from the source."""
    from repro_torch.launch.dryrun import TRAIN_MICROBATCHES
    tree = ast.parse(open(os.path.join(
        ROOT, "src", "repro", "launch", "dryrun.py")).read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and \
                getattr(node.targets[0], "id", None) == "TRAIN_MICROBATCHES":
            assert ast.literal_eval(node.value) == TRAIN_MICROBATCHES
            return
    raise AssertionError("no TRAIN_MICROBATCHES in the reference")


# ---------------------------------------------------------------------------
# shard, placements, meshes
# ---------------------------------------------------------------------------

def test_shard_outside_a_context_is_the_input_and_checks_rank_inside():
    x = torch.zeros(2, 3)
    assert ts.shard(x, "batch", None, "embed") is x       # no rank check
    shape, axes = MESHES["16x16"]
    with ts.use_sharding(Mesh(shape, axes, "cpu"), ts.TRAIN_RULES):
        with pytest.raises(ValueError, match="rank mismatch"):
            ts.shard(x, "batch", None, "embed")
    with js.use_sharding(_JMesh(shape, axes), js.TRAIN_RULES):
        with pytest.raises(ValueError, match="rank mismatch"):
            js.shard(jax.numpy.zeros((2, 3)), "batch", None, "embed")


def test_spec_placements_shard_tuples_in_mesh_order():
    from torch.distributed.tensor import Replicate, Shard
    mesh = make_production_mesh(multi_pod=True)
    assert mesh.size() == 512 and describe(mesh) == {
        "pod": 2, "data": 16, "model": 16}
    assert ts.spec_placements(ts.P(("pod", "data"), None, "model"), mesh) \
        == (Shard(0), Shard(0), Shard(2))
    assert ts.spec_placements(ts.P(None, "data"), mesh) == \
        (Replicate(), Shard(1), Replicate())
    assert ts.shard_shape((64, 3, 32), ts.P(("pod", "data"), None, "model"),
                          mesh) == (2, 3, 2)
    t = ts.abstract_tensor((64, 3, 32), torch.bfloat16, mesh,
                           ts.P(("pod", "data"), None, "model"))
    assert tuple(t.to_local().shape) == (2, 3, 2) and t.to_local().is_meta
    one = fake_device_mesh((1, 1), ("data", "model"))
    assert ts.spec_placements(ts.P("data", "model"), one) == \
        (Replicate(), Replicate())


def test_production_meshes_switch_between_256_and_512_ranks():
    import torch.distributed as dist
    for multi_pod, n, axes in ((False, 256, ("data", "model")),
                               (True, 512, ("pod", "data", "model")),
                               (False, 256, ("data", "model"))):
        mesh = make_production_mesh(multi_pod=multi_pod)
        assert dist.get_world_size() == n and dist.get_backend() == "fake"
        assert mesh.mesh_dim_names == axes
        assert describe(mesh) == dict(zip(axes, (2, 16, 16)[-len(axes):]))
    assert make_production_mesh() is make_production_mesh()
    assert describe(Mesh((2, 3), ("a", "b"), "cpu")) == {"a": 2, "b": 3}
    close_fake_world()
    assert not dist.is_initialized()


def test_a_fake_mesh_is_of_the_device_type_named_or_the_hosts():
    """Unnamed, a fake mesh is "cuda" where a card is present, else "cpu";
    a named type is kept, and meshes of two types are two meshes."""
    import torch.distributed as dist
    want = "cuda" if torch.cuda.is_available() else "cpu"
    assert fake_device_type() == want
    assert make_production_mesh().device_type == want
    cpu = make_production_mesh(device_type="cpu")
    assert cpu.device_type == "cpu"
    assert make_production_mesh(device_type="cpu") is cpu
    assert fake_device_mesh((2, 2), ("data", "model"), "cpu") \
        .device_type == "cpu"
    close_fake_world()
    assert not dist.is_initialized()


def test_shard_redistributes_dtensors_and_distributes_plain_tensors():
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = fake_device_mesh((4, 4), ("data", "model"))
    with ts.use_sharding(mesh, ts.DECODE_RULES):
        x = ts.shard(torch.zeros(8, 16, 4, device="meta"),
                     "batch", "cache_seq", None)
        assert isinstance(x, DTensor)
        assert tuple(x.placements) == (Shard(0), Shard(1))
        assert tuple(x.to_local().shape) == (2, 4, 4)
        y = ts.shard(x, "batch", None, None)      # gathers the length
        assert tuple(y.placements) == (Shard(0), Replicate())
        assert ts.shard(y, "batch", None, None) is y
        # the dense cache comes out length-sharded, as the reference's
        cache = get_config("qwen2-7b")
        attn = t_transformer.init_attn_cache(cache, 8, 64, torch.bfloat16,
                                             device="meta")
        assert tuple(attn["k"].placements) == (Shard(0), Shard(1))
        assert tuple(attn["v"].to_local().shape) == (2, 16, 4, 128)
        assert not isinstance(attn["pos"], DTensor)


def test_first_argmax_takes_the_first_maximum():
    x = torch.tensor([[1.0, 3.0, 3.0, 2.0], [5.0, 5.0, 0.0, 5.0]])
    assert ts.first_argmax(x).tolist() == [1, 0]
    assert ts.first_argmax(x).dtype == torch.int32
    assert torch.equal(ts.first_argmax(x), x.argmax(-1).int())


def _count_shard_calls(path):
    tree = ast.parse(open(path).read())
    return sum(isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
               and n.func.id == "shard" for n in ast.walk(tree))


def test_dense_path_shards_at_the_references_sites(monkeypatch):
    """The thirteen dense ``shard`` sites: as many calls in the sources
    of ``layers`` and ``transformer``, and, in a prefill that fills a
    cache, the same logical axes as the JAX package's."""
    for mod in ("layers", "transformer"):
        assert _count_shard_calls(os.path.join(
            ROOT, "src", "repro_torch", "models", mod + ".py")) == \
            _count_shard_calls(os.path.join(ROOT, "src", "repro", "models",
                                            mod + ".py"))
    seen = {"jax": set(), "torch": set()}

    def spy(key):
        def shard(x, *axes):
            seen[key].add(axes)
            return x
        return shard
    for mod in (j_layers, j_transformer):
        monkeypatch.setattr(mod, "shard", spy("jax"))
    for mod in (t_layers, t_transformer):
        monkeypatch.setattr(mod, "shard", spy("torch"))
    f32 = dict(param_dtype="float32", compute_dtype="float32",
               cache_dtype="float32")
    jcfg = j_reduced(j_get_config("qwen2-7b"))
    jm = j_build(jcfg, JRun(**f32))
    jp = jm.init(jax.random.key(0))
    toks = np.arange(2 * 8, dtype=np.int32).reshape(2, 8) % 256
    _, jc, _ = jm.forward(jp, {"tokens": toks}, cache=jm.init_cache(2, 16))
    jm.forward(jp, {"tokens": toks[:, :1]}, cache=jc, decode=True)
    tm = build_model(reduced_config(get_config("qwen2-7b")), RunConfig(**f32))
    tp = from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    _, tc, _ = tm.forward(tp, {"tokens": torch.from_numpy(toks)},
                          cache=tm.init_cache(2, 16, device="cpu"))
    tm.forward(tp, {"tokens": torch.from_numpy(toks[:, :1])}, cache=tc,
               decode=True)
    assert seen["torch"] == seen["jax"]
    assert len(seen["jax"]) == 6          # decode's ("batch", "seq", "embed")


# ---------------------------------------------------------------------------
# heads split unevenly over a mesh axis
# ---------------------------------------------------------------------------

def test_merge_ready_gathers_an_unevenly_split_first_dim_only():
    """``merge_ready`` gathers the merged dims but the first, and the
    first too where its shards are uneven (5 heads over 2), which DTensor
    cannot flatten; an even first dim keeps its shards, and a plain
    tensor is returned as it is, so the unsharded path runs the same
    ops."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    mesh = fake_device_mesh((2, 2), ("pod", "model"))
    plain = torch.zeros(1, 1, 5, 2, 16)
    assert ts.merge_ready(plain, 2, 5) is plain
    for heads, want in ((5, Replicate()), (4, Shard(2))):
        x = distribute_tensor(
            torch.empty(1, 1, heads, 2, 16, device="meta"), mesh,
            (Shard(2), Shard(3)), src_data_rank=None)
        got = ts.merge_ready(x, 2, 5)
        assert tuple(got.placements) == (want, Replicate())
        assert tuple(got.reshape(1, 1, heads * 32).shape) == \
            (1, 1, heads * 32)


def test_uneven_kv_heads_lower_their_decode_step_on_a_pod_mesh():
    """Hymba's reduced config with its published 5 KV heads (10 query
    heads) does not divide the 'pod' axis of 2: its long-context decode
    step lowers on a fake (2, 2, 2) mesh and gives a dry-run record (the
    ROADMAP's erring hymba-1.5b long_500k cell on 2 x 16 x 16 met
    "Cannot flatten unevenly sharded tensor" at the attention output's
    merging reshape)."""
    import dataclasses as dc
    from repro_torch.launch import dryrun
    cfg = dc.replace(reduced_config(get_config("hymba-1.5b")),
                     num_heads=10, num_kv_heads=5)
    shape = dc.replace(SHAPES["long_500k"], seq_len=64, global_batch=1)
    mesh = fake_device_mesh((2, 2, 2), ("pod", "data", "model"))
    low, meta = dryrun.lower_cell(cfg, shape, mesh, dryrun._run_config(shape))
    rec = dryrun.analyze(low, mesh, meta)
    assert rec["n_devices"] == 8
    assert rec["mesh"] == {"pod": 2, "data": 2, "model": 2}
    assert rec["memory"]["per_device_total"] > 0
    assert rec["walker"]["flops"] > 0


def test_batch_laid_lays_plain_inputs_out_along_their_batch():
    """A step's plain inputs (the whole value on every rank) are laid out
    along their batch by the rules, M-RoPE's [3, B, S] positions along
    dim 1, with no collective; DTensors, scalars and every input outside
    a sharding context are returned as they are."""
    from torch.distributed.tensor import Replicate, Shard
    tokens = torch.zeros(8, 16, dtype=torch.int32, device="meta")
    assert ts.batch_laid({"tokens": tokens})["tokens"] is tokens
    mesh = fake_device_mesh((4, 2), ("data", "model"))
    with ts.use_sharding(mesh, ts.TRAIN_RULES):
        got = ts.batch_laid({"tokens": tokens,
                             "positions": torch.zeros(3, 8, 16,
                                                      device="meta"),
                             "step": torch.zeros((), device="meta")})
        assert tuple(got["tokens"].placements) == (Shard(0), Replicate())
        assert tuple(got["tokens"].to_local().shape) == (2, 16)
        assert tuple(got["positions"].placements) == (Shard(1), Replicate())
        assert not ts.is_dtensor(got["step"])
        assert ts.batch_laid(got["tokens"]) is got["tokens"]


def test_local_like_cuts_a_plain_tensor_to_the_dtensors_shard():
    """Beside a DTensor, a plain tensor is the whole value (replicated):
    ``local_like`` cuts it to the same shard along the named dims, as the
    decode cache write cuts the whole batch's positions to its rows."""
    from torch.distributed.tensor import distribute_tensor, Shard
    mesh = fake_device_mesh((4, 2), ("data", "model"))
    cache = distribute_tensor(torch.empty(8, 16, 2, 4, device="meta"), mesh,
                              (Shard(0), Shard(1)), src_data_rank=None)
    pos = torch.arange(8, device="meta")
    assert tuple(ts.local_like(pos, cache, (0,)).shape) == (2,)
    assert ts.local_like(pos, pos, (0,)) is pos

"""The port's meshes over distinct ranks (``repro_torch.launch.world``)
against the JAX package's meshes over several devices
(``tests/test_distributed.py``).

The JAX package forces eight host devices; here eight CPU processes
joined by a gloo process group play them, started by the port's own
``spawn``, each meeting the others in a ``FileStore`` under ``tmp_path``.
Each rank holds its own shards, and the collectives move data between
processes.  The JAX side runs in this process (one device), or, where it
needs its eight devices, in a subprocess as ``tests/test_distributed.py``
runs it.

* The train step of the reference's tiny dense config on a 2 x 4
  ``("data", "model")`` mesh, the JAX package's initial state carried
  across and placed by ``models.params.place``, against the JAX package's
  single-device step: the loss within the reference's rtol 1e-4; the
  gradients within the port's single-device bounds of
  ``tests/test_torch_train.py`` (their norm 1e-4 relative, each leaf 1e-3
  of its largest: the config's float32 floor); the new parameters and
  moments within 1e-6 of the JAX package's AdamW applied to those
  gradients; and the parameters against the reference's single-device
  step at the reference's atol 2e-4 / rtol 2e-3 for all but 1e-4 of the
  elements.  Elementwise, that last bound is not met by the port's one
  device either (2 of 90,432 elements at this seed, 3 on 2 x 4;
  tests/test_torch_train.py found the same): AdamW's first step,
  lr g / (|g| + eps), turns a float32 gradient difference near g = 0 into
  up to lr of a parameter.
* Reduced ``gemma2-2b``: prefill and 4 decode steps on 2 x 4 under the
  decode rules give the JAX package's single-device tokens exactly.
* The collective atom on an 8-rank ``"model"`` axis: its plan key and
  quantized bytes are the reference atom's on 8 host devices, the
  operator counter counts its wire bytes within 5% (as the reference's
  walker does), and each kind's result is its plain version's.
* A fused, mesh-bound replay on a (2,) mesh of distinct ranks, on both
  backends: every rank's ``consumed`` is the others' and the shared
  mesh's replay's, bit for bit; the burns, passes and wire steps are the
  schedule's exactly; the barrier path moves the same wire bytes.
* ``spawn`` fails with a raising rank's traceback and ends a hung world
  at its deadline.

The rank functions below run in spawned processes, which import this
module: it imports no JAX at its top.
"""
import json
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from repro_torch.launch import world

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
TIMEOUT = 560.0            # each test's deadline (a world's, a subprocess's), the reference's
TINY_KW = dict(name="d", family="dense", num_layers=2, d_model=64,
               num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
               vocab_size=256, tie_embeddings=True)
RUN_KW = dict(param_dtype="float32", compute_dtype="float32", remat="none",
              loss_chunk=0)
OPT_KW = dict(lr=1e-2, warmup_steps=1, decay_steps=100, weight_decay=0.0)
SERVE_RUN_KW = dict(param_dtype="float32", compute_dtype="float32",
                    cache_dtype="float32", remat="none")
LOSS_RTOL = 1e-4           # tests/test_distributed.py
PARAM_ATOL, PARAM_RTOL = 2e-4, 2e-3
OUTSIDE_SHARE = 1e-4       # of the parameters' elements, AdamW's floor
GRAD_NORM_TOL = 1e-4       # tests/test_torch_train.py
GRAD_TOL = 1e-3            # of a leaf's largest
SMALL_TOL = 1e-6
WIRE = 8 * 1024 * 1024.0   # the reference atom's wire bytes
# the emulator of the replay tests (tests/test_torch_collectives.py)
TILE, BLOCK = 64, 1 << 18
FPI, BPI = 2.0 * TILE ** 3, 2.0 * BLOCK
REPLAY = [{"flops": FPI, "hbm": BPI, "ici": 4e6}, {"flops": 2 * FPI},
          {"ici": 2e6}, {"flops": FPI, "sw": 2 << 20, "ici": 1e6},
          {"hbm": BPI, "ici": 4e6}, {"flops": 3 * FPI, "hbm": 2 * BPI}]


def _spawn(fn, n, *args, tmp_path, **kw):
    return world.spawn(fn, n, *args, store=str(tmp_path / "store"),
                       device="cpu", timeout=TIMEOUT, **kw)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


def _whole(tree):
    """A tree of DTensors as numpy arrays of the whole values (a
    collective on every rank)."""
    from repro_torch.models.params import map_tensors
    return map_tensors(tree, lambda t: t.full_tensor().detach().numpy())


# ---------------------------------------------------------------------------
# rank functions (run in the spawned ranks)
# ---------------------------------------------------------------------------

def _train_rank(rank, state_np, batch_np):
    from repro_torch.configs.base import ModelConfig
    from repro_torch.configs.run import RunConfig
    from repro_torch.models.model_zoo import build_model
    from repro_torch.models.params import place, train_state_from_numpy
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.parallel.sharding import TRAIN_RULES, make_rules
    from repro_torch.train import step as step_mod

    model = build_model(ModelConfig(**TINY_KW), RunConfig(**RUN_KW))
    mesh = world.device_mesh((2, 4), ("data", "model"), "cpu")
    specs = step_mod.train_state_specs(model, mesh,
                                       make_rules(mesh, TRAIN_RULES))
    state = place(
        train_state_from_numpy(state_np, device="cpu"), mesh, specs)
    placements = {k: str(tuple(v.placements)) for k, v in
                  (("embed", state["params"]["embed"]),
                   ("mu_wq", state["opt"]["mu"]["layers"]["attn"]["wq"]))}
    grads = {}
    update = step_mod.adamw_update

    def capture(g, *a, **kw):
        grads["g"] = g
        return update(g, *a, **kw)
    step_mod.adamw_update = capture
    batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    new, metrics = step_mod.make_train_step(
        model, OptConfig(**OPT_KW), mesh)(state, batch)
    return {"loss": float(metrics["loss"].full_tensor()),
            "params": _whole(new["params"]),
            "mu": _whole(new["opt"]["mu"]), "nu": _whole(new["opt"]["nu"]),
            "grads": _whole(grads["g"]), "placements": placements}


def _decode_rank(rank, params_np, toks):
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.configs.run import RunConfig
    from repro_torch.models.model_zoo import build_model
    from repro_torch.models.params import from_numpy, place
    from repro_torch.parallel.sharding import DECODE_RULES, make_rules
    from repro_torch.serve.step import make_decode_step, make_prefill_step

    model = build_model(reduced_config(get_config("gemma2-2b")),
                        RunConfig(**SERVE_RUN_KW))
    mesh = world.device_mesh((2, 4), ("data", "model"), "cpu")
    params = place(from_numpy(params_np, device="cpu"), mesh,
                   model.param_specs(make_rules(mesh, DECODE_RULES)))
    prefill = make_prefill_step(model, max_len=16, mesh=mesh)
    decode = make_decode_step(model, mesh=mesh)
    tok, cache = prefill(params, {"tokens": torch.from_numpy(toks)})
    k = cache["attn"]["k"]
    out = [tok.full_tensor()[:, 0].tolist()]
    for _ in range(4):
        tok, cache = decode(params, tok, cache)
        out.append(tok.full_tensor()[:, 0].tolist())
    return {"tokens": out, "cache_local": tuple(k.to_local().shape),
            "cache_shape": tuple(k.shape)}


def _mamba_rank(rank, state_np, toks, batch_np):
    """Reduced Mamba-2 on 2 x 4: a prefill that returns the cache and
    MAMBA_DECODE_STEPS decode steps, then one train step."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.configs.run import RunConfig
    from repro_torch.models.model_zoo import build_model
    from repro_torch.models.params import (from_numpy, place,
                                           train_state_from_numpy)
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.parallel.sharding import (DECODE_RULES, TRAIN_RULES,
                                               make_rules)
    from repro_torch.serve.step import make_decode_step, make_prefill_step
    from repro_torch.train import step as step_mod

    cfg = reduced_config(get_config("mamba2-780m"))
    mesh = world.device_mesh((2, 4), ("data", "model"), "cpu")
    out = {}
    with torch.no_grad():
        model = build_model(cfg, RunConfig(**SERVE_RUN_KW))
        params = place(from_numpy(state_np["params"], device="cpu"), mesh,
                       model.param_specs(make_rules(mesh, DECODE_RULES)))
        tok, cache = make_prefill_step(model, max_len=toks.shape[1],
                                       mesh=mesh)(
            params, {"tokens": torch.from_numpy(toks)})
        c = cache["ssm"]
        out["placements"] = {k: str(tuple(v.placements))
                             for k, v in c.items()}
        out["cache"] = {k: v.full_tensor().numpy() for k, v in c.items()}
        out["tokens"] = [tok.full_tensor()[:, 0].tolist()]
        decode = make_decode_step(model, mesh=mesh)
        for _ in range(MAMBA_DECODE_STEPS):
            tok, cache = decode(params, tok, cache)
            out["tokens"].append(tok.full_tensor()[:, 0].tolist())
        out["decoded_placements"] = {
            k: str(tuple(v.placements)) for k, v in cache["ssm"].items()}
        out["decoded_cache"] = {k: v.full_tensor().numpy()
                                for k, v in cache["ssm"].items()}

    model = build_model(cfg, RunConfig(**RUN_KW))
    specs = step_mod.train_state_specs(model, mesh,
                                       make_rules(mesh, TRAIN_RULES))
    state = place(train_state_from_numpy(state_np, device="cpu"), mesh,
                  specs)
    grads = {}
    update = step_mod.adamw_update

    def capture(g, *a, **kw):
        grads["g"] = g
        return update(g, *a, **kw)
    step_mod.adamw_update = capture
    batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    new, metrics = step_mod.make_train_step(
        model, OptConfig(**OPT_KW), mesh)(state, batch)
    out.update(loss=float(metrics["loss"].full_tensor()),
               params=_whole(new["params"]), grads=_whole(grads["g"]))
    return out


def _moe_rank(rank, arch, shape, state_np, batch_np):
    """Reduced ``arch`` (an MoE config) on a ``shape`` ("data", "model")
    mesh: one float32 train step; its loss, aux losses and whole
    gradients."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.configs.run import RunConfig
    from repro_torch.models.model_zoo import build_model
    from repro_torch.models.params import place, train_state_from_numpy
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.parallel.sharding import TRAIN_RULES, make_rules
    from repro_torch.train import step as step_mod

    model = build_model(reduced_config(get_config(arch)),
                        RunConfig(**RUN_KW))
    mesh = world.device_mesh(shape, ("data", "model"), "cpu")
    state = place(train_state_from_numpy(state_np, device="cpu"), mesh,
                  step_mod.train_state_specs(model, mesh,
                                             make_rules(mesh, TRAIN_RULES)))
    grads = {}
    update = step_mod.adamw_update

    def capture(g, *a, **kw):
        grads["g"] = g
        return update(g, *a, **kw)
    step_mod.adamw_update = capture
    batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    _, metrics = step_mod.make_train_step(
        model, OptConfig(**OPT_KW), mesh)(state, batch)
    return {"metrics": {k: float(v.full_tensor()) for k, v in
                        metrics.items() if k == "loss" or
                        k.startswith("moe_")},
            "grads": _whole(grads["g"])}


def _atom_rank(rank, blk):
    import torch.distributed as dist

    from repro_torch.core.atoms import CollectiveAtom
    from repro_torch.core.op_analysis import count_ops
    from repro_torch.kernels.collective import ref as coll_ref

    mesh = world.RankMesh((8,), ("model",), "cpu")
    keys = []

    class Grab:                    # a cache that records each plan's key
        def get_or_build(self, key, builder):
            keys.append(key)
            return builder()
    atom = CollectiveAtom(mesh, axis="model", kind="all-reduce")
    atom.cache = Grab()
    got = atom.plan(WIRE)()
    n_elems = keys[0][-1]
    x = atom.plan_operand(n_elems)
    counter, out = count_ops(atom._coll_fn(), x)
    if not torch.equal(out, torch.full_like(x, 8.0)):
        raise AssertionError("the all-reduce of ones is not 8")
    # each kind against its plain version on the blocks of every rank
    blocks = torch.from_numpy(blk)              # [8, BLK], rank i's row i
    errs = {}
    for kind in ("all-reduce", "all-gather", "collective-permute"):
        want = coll_ref.collective(blocks, dim=0, kind=kind)[rank]
        errs[kind] = float((mesh.collective(blocks[rank].clone(), "model",
                                            kind) - want).abs().max())
    w = atom.loop_operand()
    mesh.loop(w, "model", "all-reduce", 3)
    errs["loop"] = float((w - 1.0).abs().max())
    every = [None] * 8
    dist.all_gather_object(every, (keys[0], got))
    return {"key": keys[0], "got": got,
            "quantized": atom.quantized_wire_bytes(n_elems),
            "walker": counter.total.collective_total,
            "mesh_id": (mesh.shard_ids, mesh.rank, mesh.coords),
            "errs": errs, "every": every}


def _replay_rank(rank, backend, payload, tmp):
    import torch.distributed as dist

    import repro_torch.core as T
    from repro_torch.core.schedule import rehydrate_schedule
    from repro_torch.kernels.segment import ops as segment_ops

    mesh = world.RankMesh((2,), ("data",), "cpu")
    em = T.Emulator(calib=T.HostCalibration(1e9, 1e9, 1e8, 1e8),
                    compute_tile=TILE, mem_block=BLOCK, mesh=mesh,
                    backend=backend, device="cpu")
    em.storage.dir = os.path.join(tmp, f"rank{rank}")
    os.makedirs(em.storage.dir, exist_ok=True)
    tables = []
    launch = segment_ops.segment

    def record(table, **kw):
        tables.append(np.asarray(table).copy())
        return launch(table, **kw)
    segment_ops.segment = record
    sched = rehydrate_schedule(payload)
    fused = em.replay(sched, command="ranks").to_dict()
    dispatched = np.sum([t.sum(0) for t in tables], axis=0).tolist() \
        if tables else [0, 0, 0]
    fused_wire = (mesh.wire_steps, mesh.wire_bytes)
    steps0, bytes0 = mesh.wire_steps, mesh.wire_bytes
    prof = T.SynapseProfile(command="ranks", samples=[
        T.Sample(index=i, resources=T.ResourceVector(
            flops=r.get("flops", 0.0), hbm_bytes=r.get("hbm", 0.0),
            storage_write_bytes=r.get("sw", 0.0),
            ici_bytes={"all-reduce": r["ici"]} if "ici" in r else {}))
        for i, r in enumerate(REPLAY)])
    barrier = em.replay(em.compile(prof, keep_collectives=True),
                        command="ranks", planned=prof.totals).to_dict()
    em.storage.cleanup()
    every = [None] * 2
    dist.all_gather_object(every, (fused["consumed"], barrier["consumed"]))
    return {"fused": fused, "barrier": barrier, "dispatched": dispatched,
            "fused_wire": fused_wire,
            "barrier_wire": (mesh.wire_steps - steps0,
                             mesh.wire_bytes - bytes0),
            "every": every}


def _raising_rank(rank):
    import torch.distributed as dist
    dist.barrier()          # both ranks joined before one gives up
    if rank == 1:
        raise ValueError("rank one gives up")
    return rank


def _hanging_rank(rank):
    import torch.distributed as dist
    if rank == 1:
        time.sleep(3600)
    dist.barrier()
    return rank


# ---------------------------------------------------------------------------
# the train step and decode on 2 x 4
# ---------------------------------------------------------------------------

def test_sharded_train_step_matches_the_references_single_device(tmp_path):
    import jax

    from repro.configs.base import ModelConfig as JModelConfig
    from repro.configs.run import RunConfig as JRun
    from repro.models.model_zoo import build_model as j_build
    from repro.optim import adamw as jadamw
    from repro.train.step import init_train_state, make_train_step

    model = j_build(JModelConfig(**TINY_KW), JRun(**RUN_KW))
    opt = jadamw.OptConfig(**OPT_KW)
    state = init_train_state(model, jax.random.key(0))
    toks = np.random.default_rng(0).integers(0, 256, (8, 65)) \
        .astype(np.int32)
    batch = {"tokens": toks[:, :-1].copy(), "targets": toks[:, 1:].copy()}
    s0, m0 = jax.jit(make_train_step(model, opt))(state, batch)
    state_np = jax.tree.map(np.asarray, state)

    got = _spawn(_train_rank, 8, state_np, batch, tmp_path=tmp_path)

    # laid out as the reference's specs say: the table over 'model', the
    # moments over 'data' too (ZeRO-1)
    assert got["placements"]["embed"] == "(Replicate(), Shard(dim=0))"
    assert "Shard" in got["placements"]["mu_wq"].split(",")[0]
    np.testing.assert_allclose(got["loss"], float(m0["loss"]),
                               rtol=LOSS_RTOL)
    # the gradients, at the config's float32 floor
    _, _, m_g = jax.jit(lambda g: jadamw.adamw_update(
        g, state["opt"], state["params"], opt))(_j_grads(model, state,
                                                         batch))
    jg = dict(_flat(jax.tree.map(np.asarray, _j_grads(model, state,
                                                      batch))))
    pg = dict(_flat(got["grads"]))
    assert jg.keys() == pg.keys()
    norm = np.sqrt(sum(float(np.sum(np.square(v))) for v in pg.values()))
    np.testing.assert_allclose(norm, float(m_g["grad_norm"]),
                               rtol=GRAD_NORM_TOL)
    for k in jg:
        np.testing.assert_allclose(pg[k], jg[k], rtol=0,
                                   atol=GRAD_TOL * np.abs(jg[k]).max())
    # AdamW on the sharded step's own gradients: the JAX package's update
    jp, jo, _ = jadamw.adamw_update(
        jax.tree.map(np.asarray, got["grads"]), state["opt"],
        state["params"], opt)
    for name, mine, want in (("params", got["params"], jp),
                             ("mu", got["mu"], jo["mu"]),
                             ("nu", got["nu"], jo["nu"])):
        want = dict(_flat(jax.tree.map(np.asarray, want)))
        for k, v in _flat(mine):
            np.testing.assert_allclose(v, want[k], rtol=SMALL_TOL,
                                       atol=SMALL_TOL, err_msg=name + k)
    # the parameters against the reference's single-device step
    ref = dict(_flat(jax.tree.map(np.asarray, s0["params"])))
    outside = total = 0
    for k, v in _flat(got["params"]):
        close = np.abs(v - ref[k]) <= PARAM_ATOL + PARAM_RTOL * \
            np.abs(ref[k])
        outside += int((~close).sum())
        total += close.size
    assert outside <= OUTSIDE_SHARE * total, (outside, total)


# ---------------------------------------------------------------------------
# MoE on a mesh that splits the batch: the router's gradient
# ---------------------------------------------------------------------------

MOE_ARCHS = ["moonshot-v1-16b-a3b", "llama4-scout-17b-a16e"]


@pytest.fixture(scope="module")
def moe_references():
    """Per MoE architecture, the JAX package's reduced state (seed 0), a
    train batch of 4 rows, and its single-device step's metrics and
    gradients, made once."""
    refs = {}

    def get(arch):
        if arch not in refs:
            import jax

            from repro.configs import get_config, reduced_config
            from repro.configs.run import RunConfig as JRun
            from repro.models.model_zoo import build_model as j_build
            from repro.optim import adamw as jadamw
            from repro.train.step import init_train_state, make_train_step

            model = j_build(reduced_config(get_config(arch)), JRun(**RUN_KW))
            state = init_train_state(model, jax.random.key(0))
            seq = np.random.default_rng(0).integers(0, 256, (4, 17)) \
                .astype(np.int32)
            batch = {"tokens": seq[:, :-1].copy(),
                     "targets": seq[:, 1:].copy()}
            _, metrics = jax.jit(make_train_step(
                model, jadamw.OptConfig(**OPT_KW)))(state, batch)
            refs[arch] = (jax.tree.map(np.asarray, state), batch,
                          {k: float(v) for k, v in metrics.items()},
                          dict(_flat(jax.tree.map(
                              np.asarray, _j_grads(model, state, batch)))))
        return refs[arch]
    return get


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)], ids=["2x1", "2x2"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_sharded_moe_train_step_matches_the_references_single_device(
        arch, shape, moe_references, tmp_path):
    """One float32 train step of reduced ``arch`` on a mesh whose 'data'
    axis splits the batch (each rank routes its own rows, the routing
    groups), against the JAX package's single-device step from the same
    state: the loss and the aux losses within the reference's rtol, each
    gradient leaf within the file's bound of its largest, the router's
    among them.  The router is read whole by every rank's rows, so its
    gradient is a sum over the ranks; kept a rank's own it was 60% off
    (``tools/moe_router_grad_witness.py``)."""
    state_np, batch, j_metrics, j_grads = moe_references(arch)

    got = _spawn(_moe_rank, shape[0] * shape[1], arch, shape, state_np,
                 batch, tmp_path=tmp_path)

    assert set(got["metrics"]) == {"loss", "moe_load_balance",
                                   "moe_router_z", "moe_drop_fraction"}
    for k, v in got["metrics"].items():
        np.testing.assert_allclose(v, j_metrics[k], rtol=LOSS_RTOL,
                                   err_msg=k)
    mine = dict(_flat(got["grads"]))
    assert mine.keys() == j_grads.keys()
    assert "/layers/moe/router" in mine
    for k in j_grads:
        np.testing.assert_allclose(mine[k], j_grads[k], rtol=0,
                                   atol=GRAD_TOL * np.abs(j_grads[k]).max(),
                                   err_msg=k)


def _j_grads(model, state, batch):
    """The JAX package's gradients of the single-device step's loss."""
    import jax

    from repro.train.step import make_loss_fn
    loss_fn = make_loss_fn(model)
    return jax.jit(jax.grad(lambda p: loss_fn(p, batch)[0]))(
        state["params"])


def test_sharded_decode_matches_the_references_single_device(tmp_path):
    import jax

    from repro.configs import get_config, reduced_config
    from repro.configs.run import RunConfig as JRun
    from repro.models.model_zoo import build_model as j_build
    from repro.serve.step import make_decode_step, make_prefill_step

    cfg = reduced_config(get_config("gemma2-2b"))
    model = j_build(cfg, JRun(**SERVE_RUN_KW))
    params = model.init(jax.random.key(0))
    toks = jax.random.randint(jax.random.key(1), (8, 8), 0, cfg.vocab_size)
    prefill = jax.jit(make_prefill_step(model, max_len=16))
    decode = jax.jit(make_decode_step(model))
    tok, cache = prefill(params, {"tokens": toks})
    want = [np.asarray(tok[:, 0]).tolist()]
    for _ in range(4):
        tok, cache = decode(params, tok, cache)
        want.append(np.asarray(tok[:, 0]).tolist())

    got = _spawn(_decode_rank, 8, jax.tree.map(np.asarray, params),
                 np.asarray(toks, dtype=np.int32), tmp_path=tmp_path)
    assert got["tokens"] == want
    # the cache holds a quarter of the length and half the batch a rank
    assert got["cache_shape"] == (2, 8, 16, 2, 16)
    assert got["cache_local"] == (2, 4, 4, 2, 16)


# ---------------------------------------------------------------------------
# Mamba-2 on 2 x 4: the SSD scan and the decode update on each rank's shards
# ---------------------------------------------------------------------------

MAMBA_DECODE_STEPS = 2


@pytest.fixture(scope="module")
def mamba_ranks(tmp_path_factory):
    """The JAX package's reduced Mamba-2 state (seed 0), its prompts and a
    train batch, and what ``_mamba_rank`` gives on a 2 x 4 world of CPU
    ranks from them."""
    import jax

    from repro.configs import get_config, reduced_config
    from repro.configs.run import RunConfig as JRun
    from repro.models.model_zoo import build_model as j_build
    from repro.train.step import init_train_state

    model = j_build(reduced_config(get_config("mamba2-780m")),
                    JRun(**RUN_KW))
    state = init_train_state(model, jax.random.key(0))
    state_np = jax.tree.map(np.asarray, state)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 256, (8, 16)).astype(np.int32)
    seq = rng.integers(0, 256, (8, 17)).astype(np.int32)
    batch = {"tokens": seq[:, :-1].copy(), "targets": seq[:, 1:].copy()}
    got = _spawn(_mamba_rank, 8, state_np, toks, batch,
                 tmp_path=tmp_path_factory.mktemp("mamba"))
    return state_np, toks, batch, got


def test_sharded_mamba2_prefill_and_cache_match_the_references_single_device(
        mamba_ranks):
    """The scan and the decode update run on each rank's shards of batch
    and heads: the prefill's token, its SSM cache, and the decode steps'
    tokens and cache are the JAX package's single-device ones, and the
    cache keeps the layout of its spec (``launch/specs.py``: the state's
    batch over 'data', its heads over 'model'; the conv window's channels
    over 'model')."""
    import jax

    from repro.configs import get_config, reduced_config
    from repro.configs.run import RunConfig as JRun
    from repro.models.model_zoo import build_model as j_build
    from repro.serve.step import make_decode_step, make_prefill_step

    state_np, toks, _, got = mamba_ranks
    model = j_build(reduced_config(get_config("mamba2-780m")),
                    JRun(**SERVE_RUN_KW))
    params = jax.tree.map(jax.numpy.asarray, state_np["params"])
    tok, cache = jax.jit(make_prefill_step(model, max_len=toks.shape[1]))(
        params, {"tokens": toks})
    want = [np.asarray(tok[:, 0]).tolist()]
    want_cache = jax.tree.map(np.asarray, cache["ssm"])
    decode = jax.jit(make_decode_step(model))
    for _ in range(MAMBA_DECODE_STEPS):
        tok, cache = decode(params, tok, cache)
        want.append(np.asarray(tok[:, 0]).tolist())
    assert got["tokens"] == want
    for mine, ref in ((got["cache"], want_cache),
                      (got["decoded_cache"],
                       jax.tree.map(np.asarray, cache["ssm"]))):
        for k in ("conv", "ssm"):
            np.testing.assert_allclose(
                mine[k], ref[k], rtol=0,
                atol=LOSS_RTOL * max(1.0, np.abs(ref[k]).max()), err_msg=k)
    for placed in (got["placements"], got["decoded_placements"]):
        assert placed == {"conv": "(Shard(dim=1), Shard(dim=3))",
                          "ssm": "(Shard(dim=1), Shard(dim=2))"}


def test_sharded_mamba2_train_step_matches_the_ports_single_device(
        mamba_ranks):
    """One float32 train step on 2 x 4 against the port's own step on one
    device with plain tensors (the JAX package's Mamba-2 gradients are
    NaN, ROADMAP.md queue 3): the loss within the reference's rtol, the
    gradients within the file's bounds (their norm, each leaf against its
    largest), among them those of A_log, D and the groups' B and C
    columns, which each rank reads for its own heads and rows only; the
    new parameters at the reference's atol / rtol."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.configs.run import RunConfig
    from repro_torch.models.model_zoo import build_model
    from repro_torch.models.params import train_state_from_numpy
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train import step as step_mod

    state_np, _, batch, got = mamba_ranks
    model = build_model(reduced_config(get_config("mamba2-780m")),
                        RunConfig(**RUN_KW))
    grads = {}
    update = step_mod.adamw_update

    def capture(g, *a, **kw):
        grads["g"] = g
        return update(g, *a, **kw)
    step_mod.adamw_update = capture
    try:
        new, metrics = step_mod.make_train_step(model, OptConfig(**OPT_KW))(
            train_state_from_numpy(state_np, device="cpu"),
            {k: torch.from_numpy(v) for k, v in batch.items()})
    finally:
        step_mod.adamw_update = update
    np.testing.assert_allclose(got["loss"], float(metrics["loss"]),
                               rtol=LOSS_RTOL)
    want = dict(_flat(map_numpy(grads["g"])))
    mine = dict(_flat(got["grads"]))
    assert want.keys() == mine.keys()
    norm = np.sqrt(sum(float(np.sum(np.square(v))) for v in want.values()))
    norm_got = np.sqrt(sum(float(np.sum(np.square(v)))
                           for v in mine.values()))
    np.testing.assert_allclose(norm_got, norm, rtol=GRAD_NORM_TOL)
    for k in want:
        np.testing.assert_allclose(mine[k], want[k], rtol=0,
                                   atol=GRAD_TOL * np.abs(want[k]).max(),
                                   err_msg=k)
    ref = dict(_flat(map_numpy(new["params"])))
    for k, v in _flat(got["params"]):
        np.testing.assert_allclose(v, ref[k], rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=k)


def map_numpy(tree):
    from repro_torch.models.params import map_tensors
    return map_tensors(tree, lambda t: t.detach().numpy())


# ---------------------------------------------------------------------------
# the collective atom on 8 ranks
# ---------------------------------------------------------------------------

REFERENCE_ATOM = """
import json, jax
from repro.core.atoms import CollectiveAtom

class Grab:
    def get_or_build(self, key, builder):
        self.key = key
        return builder()

mesh = jax.make_mesh((8,), ("model",))
atom = CollectiveAtom(mesh, axis="model", kind="all-reduce")
atom.cache = Grab()
got = atom.plan(%r)()
n = atom.cache.key[-1]
print(json.dumps({"key": atom.cache.key, "got": got,
                  "quantized": atom.quantized_wire_bytes(n)}))
"""


def test_collective_atom_on_eight_ranks_matches_the_reference(tmp_path):
    env = dict(os.environ, PYTHONPATH=SRC,
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    out = subprocess.run([sys.executable, "-c",
                          textwrap.dedent(REFERENCE_ATOM % WIRE)],
                         capture_output=True, text=True, env=env,
                         timeout=TIMEOUT)
    assert out.returncode == 0, out.stdout + out.stderr
    ref = json.loads(out.stdout.strip().splitlines()[-1])
    blk = np.random.default_rng(3).standard_normal((8, 16)) \
        .astype(np.float32)

    got = _spawn(_atom_rank, 8, blk, tmp_path=tmp_path)

    assert json.loads(json.dumps(got["key"])) == ref["key"]
    assert got["got"] == ref["got"] == got["quantized"] == ref["quantized"]
    assert abs(got["got"] - WIRE) / WIRE < 1e-3
    assert all(e == (got["key"], got["got"]) for e in got["every"])
    assert got["mesh_id"] == (tuple(range(8)), 0, (0,))
    assert abs(got["walker"] - WIRE) / WIRE < 0.05
    assert got["walker"] == got["quantized"]
    # the sum of 8 blocks in another order than ascending: float32's
    # rounding; the gather and the permute move values exactly
    assert got["errs"]["all-reduce"] < 1e-5
    assert got["errs"]["all-gather"] == got["errs"]["loop"] == 0.0
    assert got["errs"]["collective-permute"] == 0.0


# ---------------------------------------------------------------------------
# the emulator's replay on 2 ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_fused_replay_on_two_ranks_is_the_shared_meshes(backend, tmp_path):
    import repro_torch.core as T
    from repro_torch.launch.mesh import make_mesh

    em = T.Emulator(calib=T.HostCalibration(1e9, 1e9, 1e8, 1e8),
                    compute_tile=TILE, mem_block=BLOCK, backend=backend,
                    mesh=make_mesh((2,), ("data",), "cpu"), device="cpu")
    em.storage.dir = str(tmp_path)
    fused_rows = [r for r in REPLAY if "sw" not in r]
    prof = T.SynapseProfile(command="ranks", samples=[
        T.Sample(index=i, resources=T.ResourceVector(
            flops=r.get("flops", 0.0), hbm_bytes=r.get("hbm", 0.0),
            ici_bytes={"all-reduce": r["ici"]} if "ici" in r else {}))
        for i, r in enumerate(fused_rows)])
    sched = em.compile(prof)
    assert sched.mesh_bound and len(sched.segments) == 1
    shared = em.replay(sched, command="ranks").to_dict()
    seg = sched.segments[0]

    got = _spawn(_replay_rank, 2, backend, sched.detach(), str(tmp_path),
                 tmp_path=tmp_path)

    fused = got["fused"]
    assert all(e[0] == fused["consumed"] for e in got["every"])
    assert all(e[1] == got["barrier"]["consumed"] for e in got["every"])
    assert fused["consumed"] == shared["consumed"]
    for k in ("n_samples", "n_dispatches", "n_collective_dispatches",
              "emulated_ici_bytes", "mode"):
        assert fused[k] == shared[k], k
    # the burns and passes went to the segment entry, split at the wire
    # rows; the wire steps over the group, every one
    if backend == "cuda":
        assert got["dispatched"] == [seg.compute_iters, seg.memory_iters, 0]
    assert got["fused_wire"] == (seg.collective_iters,
                                 sched.collective_quant.emulated_bytes(
                                     seg.collective_iters))
    # the barrier path: one group call a wire-bearing sample, the same
    # bytes as the planned quantized amounts
    assert got["barrier_wire"][0] == 0
    assert got["barrier_wire"][1] == got["barrier"]["emulated_ici_bytes"]
    assert got["barrier"]["n_collective_dispatches"] == \
        sum(1 for r in REPLAY if "ici" in r)


# ---------------------------------------------------------------------------
# the world itself
# ---------------------------------------------------------------------------

def test_a_raising_rank_fails_spawn_with_its_traceback(tmp_path):
    with pytest.raises(RuntimeError) as err:
        _spawn(_raising_rank, 2, tmp_path=tmp_path)
    msg = str(err.value)
    assert "rank 1 of 2 failed" in msg, msg
    assert "ValueError: rank one gives up" in msg, msg
    assert "_raising_rank" in msg, msg     # the rank's own traceback


def test_a_hung_world_ends_at_its_deadline(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match=r"2 of 2 ranks did not finish in 10 s"):
        world.spawn(_hanging_rank, 2, store=str(tmp_path / "store"),
                    device="cpu", timeout=10.0)
    assert time.monotonic() - t0 < 60


def test_init_world_refuses_what_it_cannot_join(tmp_path):
    with pytest.raises(ValueError, match="nccl needs each rank"):
        world.init_world(0, 2, str(tmp_path), "nccl", device="cpu")
    with pytest.raises(ValueError, match="backend must be one of"):
        world.init_world(0, 2, str(tmp_path), "mpi", device="cpu")
    import torch.distributed as dist
    assert not dist.is_initialized()

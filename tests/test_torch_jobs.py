"""The port's jobs on a mesh of ranks: sharded checkpoints with elastic
restore, the train job (``make_job(mesh=...)``) and the serving engine
(``Engine(mesh=...)``), against the JAX package's on one device.

Two CPU processes joined by a gloo process group (``launch.world.spawn``,
as in ``tests/test_torch_ranks.py``) run the port; the JAX side runs in
this process.  The model is the reference's tiny dense config of
``tests/test_train_loop.py``, in float32.

* (a) The JAX package saves its initial state as a step-0 checkpoint; the
  port's job on a (1, 2) ``("data", "model")`` mesh and the JAX package's
  job on one device both resume it and train 4 steps on the same batches:
  the losses within the reference's rtol 1e-4 at every step.
* (b) Exact resume on the mesh: 2 steps, a checkpoint, a new job resuming
  to step 4: the losses equal 4 uninterrupted steps' bit for bit.
* (c) A failure after a checkpoint: one restart from it, and the losses of
  the uninterrupted run, bit for bit.
* (d) Elastic restore: the (1, 2) job's checkpoint restored onto (2, 1),
  onto (2,) ``("data",)`` and onto a rank with no mesh; every leaf's
  whole tensor hashes to the manifest's sha1, and one step from the
  (2, 1) restore gives the (1, 2) run's loss within 1e-4.
* (e) The checkpoint saved from the sharded state restores in the JAX
  package bit for bit, its manifest the JAX package's own for those
  arrays.
* (f) ``restore(shardings=...)`` lays each leaf out as its sharding says
  (``tests/test_infra.py::test_checkpoint_elastic_restore_reshards``).
* (g) ``Engine(mesh=(1, 2))`` serves a wave of left-padded requests with
  the JAX ``Engine``'s tokens on one device, exactly.
* (h) Rank 0 alone writes; every rank leaves ``wait`` once the step is
  committed; a write error on rank 0 is raised on both ranks, which go on
  to meet in a collective.

The rank functions below run in spawned processes, which import this
module: it imports no JAX at its top.  Each world runs several checks and
reports each one's result or traceback, so that a failure names its
check.
"""
import hashlib
import json
import os
import traceback

import numpy as np
import pytest
import torch

from repro_torch.launch import world

TIMEOUT = 300.0            # a world's deadline
TINY_KW = dict(name="tiny-lm", family="dense", num_layers=2, d_model=64,
               num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
               vocab_size=128, tie_embeddings=True)
RUN_KW = dict(param_dtype="float32", compute_dtype="float32", remat="none",
              loss_chunk=0)
SERVE_RUN_KW = dict(param_dtype="float32", compute_dtype="float32",
                    cache_dtype="float32", remat="none")
DATA_KW = dict(vocab_size=128, seq_len=64, global_batch=8, seed=3)
OPT_KW = dict(lr=1e-2, warmup_steps=10, decay_steps=2000, weight_decay=0.0)
LOSS_RTOL = 1e-4           # tests/test_distributed.py
STEPS = 4
# (g): prompts of a wave left-padded to the longest, each with its own stop
PROMPTS = ((5, 6), (8, 4), (3, 6), (8, 2))     # (prompt length, new tokens)
SERVE_MAX_LEN = 32


def _spawn(fn, *args, tmp_path):
    return world.spawn(fn, 2, *args, store=str(tmp_path / "store"),
                       device="cpu", timeout=TIMEOUT)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, np.asarray(tree)


def _np_tree(tree):
    """A JAX tree as numpy arrays (in this process only)."""
    import jax
    return jax.tree.map(np.asarray, tree)


def _sha1(a: np.ndarray) -> str:
    """The manifest's hash of a leaf (the JAX package's)."""
    return hashlib.sha1(np.ascontiguousarray(a).tobytes()).hexdigest()[:12]


def _checks(**parts):
    """Run each named check, keeping its result or its traceback."""
    out = {}
    for name, fn in parts.items():
        try:
            out[name] = ("ok", fn())
        except Exception:  # noqa: BLE001 — reported to the test
            out[name] = ("err", traceback.format_exc())
    return out


def _got(results, name):
    status, value = results[name]
    assert status == "ok", f"check {name} failed on a rank:\n{value}"
    return value


# ---------------------------------------------------------------------------
# rank functions (run in the spawned ranks)
# ---------------------------------------------------------------------------

def _job(ckpt_dir, shape, axes=("data", "model"), every=1000):
    from repro_torch.configs.base import ModelConfig
    from repro_torch.configs.run import RunConfig
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.runtime.supervisor import SupervisorConfig
    from repro_torch.train.loop import make_job
    mesh = None if shape is None else world.device_mesh(shape, axes, "cpu")
    return make_job(ModelConfig(**TINY_KW), RunConfig(**RUN_KW),
                    opt=OptConfig(**OPT_KW), data_cfg=DataConfig(**DATA_KW),
                    ckpt_dir=ckpt_dir, mesh=mesh,
                    sup_cfg=SupervisorConfig(ckpt_every=every), device="cpu")


def _hashes(tree):
    """Each leaf's whole value hashed as the manifest hashes it (a
    collective on every rank for a DTensor leaf)."""
    from repro_torch.checkpoint.ckpt import tree_flatten_named
    from repro_torch.parallel.sharding import whole
    return {k: _sha1(whole(t).numpy())
            for k, t in tree_flatten_named(tree).items()}


def _whole(tree):
    from repro_torch.models.params import map_tensors
    from repro_torch.parallel.sharding import whole
    return map_tensors(tree, lambda t: whole(t).detach().numpy().copy())


def _train_rank(rank, jax_dir, tmp):
    import torch.distributed as dist

    from repro_torch.runtime.supervisor import FailurePlan
    from repro_torch.train.loop import train

    def d(name):
        return os.path.join(tmp, name)

    def uninterrupted():
        out = train(_job(d("u"), (1, 2)), STEPS, resume=False)
        return {"losses": out["losses"],
                "placement": str(out["state"]["params"]["embed"]
                                 .placements)}

    def resumed():
        first = train(_job(d("b"), (1, 2), every=2), 2, resume=False)
        state = _whole(first["state"])
        rest = train(_job(d("b"), (1, 2)), STEPS - 2, resume=True)
        return {"losses": first["losses"] + rest["losses"], "state": state,
                "dir": d("b")}

    def failed():
        job = _job(d("f"), (1, 2), every=2)
        out = train(job, STEPS, resume=False,
                    failure_plan=FailurePlan(fail_at_steps={3: "node_lost"}))
        rep = out["report"]
        return {"losses": out["losses"], "restarts": rep.restarts,
                "restored_from": rep.restored_from,
                "failures": rep.failures,
                "placement": str(out["state"]["opt"]["mu"]["embed"]
                                 .placements)}

    def elastic():
        with open(os.path.join(d("b"), "step_00000002",
                               "manifest.json")) as f:
            want = {k: v["sha1"] for k, v in json.load(f)["leaves"].items()}
        out = {"want": want}
        for name, shape, axes in (("21", (2, 1), ("data", "model")),
                                  ("2", (2,), ("data",))):
            job = _job(d("b"), shape, axes)
            state, _ = job.ckpt.restore(shardings=job.shardings)
            out[name] = {"hashes": _hashes(state), "placements": {
                k: str(tuple(t.placements)) for k, t in (
                    ("params", state["params"]["embed"]),
                    ("mu", state["opt"]["mu"]["embed"]))}}
            if name == "21":
                out[name]["loss"] = train(job, 1, resume=True)["losses"]
        state, _ = _job(d("b"), None).ckpt.restore()
        out["none"] = {"hashes": _hashes(state), "types": sorted(
            {type(t).__name__ for t in _leaves(state)})}
        return out

    def jax_resumed():
        return train(_job(jax_dir, (1, 2)), STEPS, resume=True)["losses"]

    res = _checks(uninterrupted=uninterrupted, resumed=resumed,
                  failed=failed, elastic=elastic, jax_resumed=jax_resumed)
    every = [None] * 2
    dist.all_gather_object(every, res)
    return {"ranks": every}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _manager_rank(rank, tmp):
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.checkpoint.ckpt import CheckpointManager
    from repro_torch.parallel.sharding import NamedSharding, P, distribute

    mesh = world.device_mesh((2,), ("data",), "cpu")
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.standard_normal((8, 16)).astype(np.float32))
    odd = torch.from_numpy(rng.standard_normal((7, 3)).astype(np.float32))

    def state():
        return {"params": {"w": distribute(w.clone(), mesh, P("data")),
                           "b": torch.zeros(16),
                           "odd": distribute(odd.clone(), mesh, P("data"))},
                "opt": {"mu": {"w": torch.ones(8, 16), "b": torch.zeros(16)},
                        "step": torch.tensor(7, dtype=torch.int32)}}

    def reshards():
        cm = CheckpointManager(os.path.join(tmp, "f"), device="cpu")
        cm.save(1, state())
        sh = {"params": {"w": NamedSharding(mesh, P("data")),
                         "b": NamedSharding(mesh, P()),
                         "odd": NamedSharding(mesh, P("data"))},
              "opt": {"mu": {"w": NamedSharding(mesh, P()),
                             "b": NamedSharding(mesh, P())},
                      "step": NamedSharding(mesh, P())}}
        got, _ = cm.restore(1, shardings=sh)
        gw = got["params"]["w"]
        return {"w": (tuple(gw.placements) == (Shard(0),),
                      gw.device_mesh is mesh, tuple(gw.to_local().shape),
                      bool(torch.equal(gw.full_tensor(), w))),
                "b": tuple(got["params"]["b"].placements) == (Replicate(),),
                # 7 rows over 2 ranks: 4 and 3, saved and restored whole
                "odd": (tuple(got["params"]["odd"].to_local().shape),
                        bool(torch.equal(got["params"]["odd"].full_tensor(),
                                         odd))),
                "step": int(got["opt"]["step"].full_tensor())}

    def writer():
        cm = CheckpointManager(os.path.join(tmp, "h"), device="cpu")
        calls = []
        write = cm._write

        def counted(*a, **kw):
            calls.append(a[0])
            return write(*a, **kw)
        cm._write = counted
        seen = []
        for step in (1, 2):
            cm.save_async(step, state(), {"step": step})
            cm.wait()
            seen.append(cm.latest_step())
        cm.save(3, state())
        seen.append(cm.latest_step())
        return {"calls": calls, "seen": seen}

    def write_error():
        cm = CheckpointManager(os.path.join(tmp, "e"), device="cpu")
        if rank == 0:
            def broken(*a, **kw):
                raise OSError("no space left for the checkpoint")
            cm._write = broken
        raised = []
        for sync in (False, True):
            try:
                if sync:
                    cm.save(1, state())
                else:
                    cm.save_async(1, state())
                    cm.wait()
                raised.append(None)
            except OSError as e:
                raised.append(f"{type(e).__name__}: {e}")
        dist.barrier()            # both ranks went on to meet here
        return {"raised": raised, "latest": cm.latest_step()}

    res = _checks(reshards=reshards, writer=writer, write_error=write_error)
    every = [None] * 2
    dist.all_gather_object(every, res)
    return {"ranks": every}


def _serve_rank(rank, params_np):
    from repro_torch.configs.base import ModelConfig
    from repro_torch.configs.run import RunConfig
    from repro_torch.models.model_zoo import build_model
    from repro_torch.models.params import from_numpy
    from repro_torch.serve.engine import Engine, Request

    model = build_model(ModelConfig(**TINY_KW), RunConfig(**SERVE_RUN_KW))
    mesh = world.device_mesh((1, 2), ("data", "model"), "cpu")
    eng = Engine(model, from_numpy(params_np, device="cpu"),
                 batch_slots=len(PROMPTS), max_len=SERVE_MAX_LEN, mesh=mesh,
                 device="cpu")
    reqs = [Request(prompt=p, max_new_tokens=n)
            for p, n in _prompts()]
    eng.serve(reqs)
    return {"tokens": [r.out_tokens for r in reqs],
            "placement": str(tuple(eng.params["embed"].placements))}


def _prompts():
    rng = np.random.default_rng(5)
    return [(rng.integers(1, TINY_KW["vocab_size"], n).tolist(), new)
            for n, new in PROMPTS]


# ---------------------------------------------------------------------------
# the train job and its checkpoints
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def train_world(tmp_path_factory):
    """The JAX package's step-0 checkpoint and its 4-step job on one
    device; then the port's world of 2 ranks runs every train check."""
    import jax
    import jax.numpy as jnp

    from repro.checkpoint.ckpt import CheckpointManager as JCkpt
    from repro.configs.base import ModelConfig as JModelConfig
    from repro.configs.run import RunConfig as JRun
    from repro.optim.adamw import OptConfig as JOpt
    from repro.runtime.supervisor import SupervisorConfig as JSup
    from repro.train.loop import make_job as j_make_job
    from repro.train.loop import train as j_train
    from repro.train.step import init_train_state as j_init
    from repro_torch.data.pipeline import DataConfig, SyntheticLM

    tmp = tmp_path_factory.mktemp("jobs")
    jax_dir = str(tmp / "jax")
    job = j_make_job(JModelConfig(**TINY_KW), JRun(**RUN_KW),
                     opt=JOpt(**OPT_KW), ckpt_dir=jax_dir,
                     sup_cfg=JSup(ckpt_every=1000))
    JCkpt(jax_dir).save(0, j_init(job.model, jax.random.key(0)),
                        {"step": 0})
    # the port's batches, given to the JAX job (the packages' token
    # streams differ: numpy Philox against threefry)
    port_data = SyntheticLM(DataConfig(**DATA_KW), device="cpu")

    class PortBatches:
        def batch_at(self, step):
            h = port_data.host_batch_at(step)
            return {"tokens": jnp.asarray(h[0]), "targets": jnp.asarray(h[1])}

        def state(self, step):
            return port_data.state(step)
    job.data = PortBatches()
    jax_losses = j_train(job, STEPS, resume=True)["losses"]
    got = _spawn(_train_rank, jax_dir, str(tmp / "port"),
                 tmp_path=tmp)
    return {"jax_losses": jax_losses, "ranks": got["ranks"]}


def _rank0(w, name):
    return _got(w["ranks"][0], name)


def test_mesh_job_resumes_the_references_checkpoint_and_tracks_its_losses(
        train_world):
    got = [_got(r, "jax_resumed") for r in train_world["ranks"]]
    assert got[0] == got[1]
    want = train_world["jax_losses"]
    assert len(got[0]) == len(want) == STEPS
    np.testing.assert_allclose(got[0], want, rtol=LOSS_RTOL)


def test_mesh_job_resumes_bit_for_bit(train_world):
    cont = _rank0(train_world, "uninterrupted")
    res = _rank0(train_world, "resumed")
    assert len(cont["losses"]) == STEPS
    assert res["losses"] == cont["losses"]
    # the table over 'model' (the vocab), as the reference's rules say
    assert cont["placement"] == "(Replicate(), Shard(dim=0))"
    assert all(_got(r, "resumed")["losses"] == res["losses"]
               for r in train_world["ranks"])


def test_mesh_job_restarts_from_its_checkpoint(train_world):
    cont = _rank0(train_world, "uninterrupted")["losses"]
    for r in train_world["ranks"]:
        got = _got(r, "failed")
        assert got["restarts"] == 1
        assert got["restored_from"] == [2]
        assert got["failures"] == ["InjectedFailure: node_lost@3"]
        # steps 0-2, the failure at 3, steps 2-3 again from the checkpoint
        assert got["losses"] == cont[:3] + cont[2:]
        assert got["placement"] == "(Replicate(), Shard(dim=0))"


def test_checkpoint_restores_elastically_onto_other_meshes(train_world):
    cont = _rank0(train_world, "uninterrupted")["losses"]
    for r in train_world["ranks"]:
        got = _got(r, "elastic")
        want = got["want"]
        assert set(want) == set(got["none"]["hashes"])
        for mesh in ("21", "2", "none"):
            assert got[mesh]["hashes"] == want, mesh
        assert got["none"]["types"] == ["Tensor"]
        # laid out by the new mesh's specs: the moments ZeRO-1 over the
        # two data ranks, where (1, 2) split the table over 'model'
        assert got["21"]["placements"] == {
            "params": "(Replicate(), Replicate())",
            "mu": "(Shard(dim=1), Replicate())"}
        assert got["2"]["placements"] == {"params": "(Replicate(),)",
                                          "mu": "(Shard(dim=0),)"}
        assert len(got["21"]["loss"]) == 1
        np.testing.assert_allclose(got["21"]["loss"][0], cont[2],
                                   rtol=LOSS_RTOL)


def test_sharded_checkpoint_restores_in_the_reference_bit_for_bit(
        train_world, tmp_path):
    from repro.checkpoint.ckpt import CheckpointManager as JCkpt
    res = _rank0(train_world, "resumed")
    got, extra = JCkpt(res["dir"]).restore(2)
    assert extra["step"] == 2
    want = dict(_flat(res["state"]))
    mine = dict(_flat(_np_tree(got)))
    assert mine.keys() == want.keys()
    for k, v in want.items():
        assert mine[k].dtype == v.dtype, k
        assert mine[k].shape == v.shape, k
        np.testing.assert_array_equal(mine[k], v, err_msg=k)
    # the manifest is the JAX package's own for the same arrays
    JCkpt(str(tmp_path)).save(2, res["state"])
    with open(os.path.join(res["dir"], "step_00000002",
                           "manifest.json")) as f:
        ours = json.load(f)["leaves"]
    with open(tmp_path / "step_00000002" / "manifest.json") as f:
        theirs = json.load(f)["leaves"]
    assert ours == theirs


# ---------------------------------------------------------------------------
# the manager itself
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def manager_world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("manager")
    return _spawn(_manager_rank, str(tmp / "ck"), tmp_path=tmp)["ranks"]


def test_checkpoint_elastic_restore_reshards(manager_world):
    for r in manager_world:
        got = _got(r, "reshards")
        assert got["w"] == (True, True, (4, 16), True)
        assert got["b"] is True
        assert got["step"] == 7
    assert [_got(r, "reshards")["odd"] for r in manager_world] == [
        ((4, 3), True), ((3, 3), True)]


def test_rank_zero_alone_writes_and_every_rank_sees_the_commit(
        manager_world):
    zero, one = (_got(r, "writer") for r in manager_world)
    assert zero["calls"] == [1, 2, 3] and one["calls"] == []
    # no rank leaves wait() (or save()) before the step is committed
    assert zero["seen"] == one["seen"] == [1, 2, 3]


def test_a_write_error_on_rank_zero_is_raised_on_every_rank(manager_world):
    msg = "OSError: no space left for the checkpoint"
    for r in manager_world:
        got = _got(r, "write_error")
        assert got["raised"] == [msg, msg]
        assert got["latest"] is None


# ---------------------------------------------------------------------------
# the serving engine
# ---------------------------------------------------------------------------

def test_mesh_engine_serves_the_references_tokens(tmp_path):
    import jax

    from repro.configs.base import ModelConfig as JModelConfig
    from repro.configs.run import RunConfig as JRun
    from repro.models.model_zoo import build_model as j_build
    from repro.serve.engine import Engine as JEngine
    from repro.serve.engine import Request as JRequest

    model = j_build(JModelConfig(**TINY_KW), JRun(**SERVE_RUN_KW))
    params = model.init(jax.random.key(1))
    reqs = [JRequest(prompt=p, max_new_tokens=n) for p, n in _prompts()]
    JEngine(model, params, batch_slots=len(PROMPTS),
            max_len=SERVE_MAX_LEN).serve(reqs)
    want = [r.out_tokens for r in reqs]
    assert [len(t) for t in want] == [n for _, n in PROMPTS]

    got = _spawn(_serve_rank, _np_tree(params), tmp_path=tmp_path)
    assert got["tokens"] == want
    # laid out by the decode rules: the table over 'model'
    assert got["placement"] == "(Replicate(), Shard(dim=0))"

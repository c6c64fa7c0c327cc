"""Multi-pod dry-run: the JAX package's ``launch/dryrun.py`` on DTensors.

For every (architecture × input shape) cell, run the cell's step function
once on the production mesh — 16×16 single pod and 2×16×16 multi-pod, as
``DeviceMesh``es over a fake process group of 256 or 512 ranks — on
parameters, state and inputs that are DTensors with meta shards, under the
operator counter (``core.op_analysis.OpCounter``).  Nothing is allocated
and nothing launches; this process plays rank 0.  DTensor's sharding
propagation lays out every op, as GSPMD partitions the JAX package's step,
and the counter counts the local program: one device's flops and bytes,
the wire bytes of the collectives DTensor issues (by mesh axis), and the
peak of the bytes the step holds.  Each cell writes a JSON artifact under
``experiments/artifacts_torch/`` with the JAX package's keys (but
``xla_cost``: there is no compiler to ask).

Usage (no card needed):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--skip-existing]
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import traceback
from typing import Optional

import torch
from torch.utils._pytree import tree_leaves

from repro_torch.configs import SHAPES, cell_is_runnable, get_config, list_archs
from repro_torch.configs.run import RunConfig, for_shape
from repro_torch.core import op_analysis
from repro_torch.launch.mesh import describe, make_production_mesh
from repro_torch.launch.specs import input_specs, rules_table_for
from repro_torch.models.model_zoo import build_model
from repro_torch.obs import clock as obs_clock
from repro_torch.optim.adamw import OptConfig
from repro_torch.parallel.sharding import local, make_rules
from repro_torch.serve.step import make_decode_step, make_prefill_step
from repro_torch.train.step import abstract_train_state, make_train_step

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "experiments", "artifacts_torch")


# Gradient-accumulation defaults for the big train cells: activations scale
# with tokens/microbatch, so temp memory divides by m.
TRAIN_MICROBATCHES = {
    "llama4-scout-17b-a16e": 4,
    "qwen2-72b": 4,
    "moonshot-v1-16b-a3b": 4,
    "hymba-1.5b": 2,            # banded-bwd dk/dv carries need headroom
}


def _run_config(shape, overrides=None, arch=None) -> RunConfig:
    run = for_shape(shape.kind)
    if shape.kind == "train" and arch in TRAIN_MICROBATCHES:
        run = dataclasses.replace(
            run, microbatches=TRAIN_MICROBATCHES[arch])
    if overrides:
        run = dataclasses.replace(run, **overrides)
    return run


@dataclasses.dataclass
class Lowered:
    """What one counted run of a cell's step gives, per device: the cost,
    the counter's peak of live bytes, the local bytes of the arguments, of
    the outputs, of the outputs the step allocated (not its arguments
    updated in place) and of the donated argument (the train state, the
    decode cache) and the run's seconds."""
    cost: op_analysis.OpCost
    peak_live_bytes: float
    argument_bytes: int
    output_bytes: int
    fresh_output_bytes: int
    alias_bytes: int
    run_s: float


def cell_step(cfg, shape, mesh, run: RunConfig):
    """The cell's step function and its abstract arguments: ``(step, args,
    donated argument index or None, meta)``."""
    model = build_model(cfg, run)
    table = rules_table_for(shape, run)
    rules = make_rules(mesh, table)
    meta = {"params": model.num_params(),
            "active_params": cfg.active_param_count()}
    if shape.kind == "train":
        step = make_train_step(model, OptConfig(), mesh, rules_table=table)
        state = abstract_train_state(model, mesh, rules)
        (batch,) = input_specs(cfg, shape, mesh, run)
        args, donated = (state, batch), 0
        tokens = shape.global_batch * shape.seq_len
        if cfg.family == "encdec":
            tokens //= 2          # src/tgt split: each stack sees seq/2
        meta["model_flops"] = 6.0 * meta["active_params"] * tokens
    elif shape.kind == "prefill":
        S = shape.seq_len
        max_len = S // 2 if cfg.family == "encdec" else S
        src_len = S // 2 if cfg.family == "encdec" else None
        step = make_prefill_step(model, max_len=max_len, src_len=src_len,
                                 mesh=mesh, rules_table=table)
        (batch,) = input_specs(cfg, shape, mesh, run)
        args, donated = (model.abstract(mesh, rules), batch), None
        tokens = shape.global_batch * shape.seq_len
        if cfg.family == "encdec":
            tokens //= 2
        meta["model_flops"] = 2.0 * meta["active_params"] * tokens
    else:  # decode
        step = make_decode_step(model, mesh=mesh, rules_table=table)
        toks, cache = input_specs(cfg, shape, mesh, run)
        args, donated = (model.abstract(mesh, rules), toks, cache), 2
        meta["model_flops"] = 2.0 * meta["active_params"] * shape.global_batch
    return step, args, donated, meta


def _local_tensors(tree):
    """The local shards of the tensors in ``tree`` (nested dicts, tuples
    and lists)."""
    return [local(t) for t in tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


def tree_bytes(tree) -> int:
    """Bytes of the local shards of the tensors in ``tree``, each tensor
    counted whole."""
    return sum(t.numel() * t.element_size() for t in _local_tensors(tree))


def _count_run(step, args, donated) -> Lowered:
    """Run ``step(*args)`` once under the counter and measure it."""
    t0 = obs_clock.now()
    counter, out = op_analysis.count_ops(step, *args)
    run_s = obs_clock.now() - t0
    arg_st = {t.untyped_storage()._cdata for t in _local_tensors(args)}
    fresh = {}
    for t in _local_tensors(out):
        st = t.untyped_storage()
        if st._cdata not in arg_st:
            fresh[st._cdata] = st.nbytes()
    return Lowered(
        cost=counter.total, peak_live_bytes=counter.peak_live_bytes,
        argument_bytes=tree_bytes(args), output_bytes=tree_bytes(out),
        fresh_output_bytes=sum(fresh.values()),
        alias_bytes=0 if donated is None else tree_bytes(args[donated]),
        run_s=run_s)


def lower_cell(cfg, shape, mesh, run: RunConfig):
    """Build the cell's step and run it once on its abstract inputs under
    the counter; returns (lowered, meta)."""
    step, args, donated, meta = cell_step(cfg, shape, mesh, run)
    return _count_run(step, args, donated), meta


def analyze(lowered: Lowered, mesh, meta):
    """The artifact's numbers of a counted run, with the JAX package's keys.

    ``memory``: ``argument_bytes`` and ``output_bytes`` are the local bytes
    of the step's inputs and outputs, ``alias_bytes`` the donated
    argument's, which the step updates in place and returns (XLA's
    donation); ``temp_bytes`` the counter's peak of the bytes the step
    allocated and held, less those of the outputs it allocated (XLA's temp
    holds neither arguments nor outputs); ``per_device_total`` the JAX
    package's formula, which comes to the arguments plus that peak;
    ``code_bytes`` 0 (no code is generated)."""
    n_dev = mesh.size()
    out = dict(meta)
    out["n_devices"] = int(n_dev)
    out["mesh"] = describe(mesh)
    # "cpu" or "cuda": DTensor lays some redistributions out by it
    out["mesh_device_type"] = mesh.device_type

    mem = {"argument_bytes": int(lowered.argument_bytes),
           "output_bytes": int(lowered.output_bytes),
           "temp_bytes": int(max(lowered.peak_live_bytes
                                 - lowered.fresh_output_bytes, 0)),
           "alias_bytes": int(lowered.alias_bytes),
           "code_bytes": 0}
    mem["per_device_total"] = (mem["argument_bytes"] + mem["output_bytes"]
                               + mem["temp_bytes"] - mem["alias_bytes"])
    out["memory"] = mem

    cost = lowered.cost
    out["walker"] = {
        "flops": cost.flops,
        "transcendentals": cost.transcendentals,
        "hbm_bytes": cost.hbm_bytes,
        "dot_bytes": cost.dot_bytes,
        "collective_bytes": cost.collective_bytes(),
        "collective_total": cost.collective_total,
        "collective_by_axis": op_analysis.attribute_axes(
            cost, describe(mesh)),
        "analysis_s": lowered.run_s,
        "top_ops": sorted(cost.op_flops.items(), key=lambda kv: -kv[1])[:12],
    }
    out["useful_flops_ratio"] = (
        meta["model_flops"] / (cost.flops * n_dev) if cost.flops else None)
    return out


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
             overrides=None, tag: str = "",
             mesh_device: Optional[str] = None) -> dict:
    """One cell's artifact, written to ``out_dir`` and returned.  The fake
    mesh is of ``mesh_device`` ("cpu" or "cuda"; by default
    ``mesh.fake_device_type()``)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh_tag = "2x16x16" if multi_pod else "16x16"
    name = f"{arch}__{shape_name}__{mesh_tag}" + (f"__{tag}" if tag else "")
    record = {"arch": arch, "shape": shape_name, "mesh_tag": mesh_tag,
              "tag": tag, "ok": False}

    ok, why = cell_is_runnable(cfg, shape)
    if not ok:
        record.update({"skipped": True, "skip_reason": why, "ok": True})
        _write(out_dir, name, record)
        return record

    try:
        mesh = make_production_mesh(multi_pod=multi_pod,
                                    device_type=mesh_device)
        run = _run_config(shape, overrides, arch=arch)
        record["run_config"] = dataclasses.asdict(run)
        t0 = obs_clock.now()
        lowered, meta = lower_cell(cfg, shape, mesh, run)
        # the counted run is the lowering and the walk in one
        record["lower_s"] = obs_clock.now() - t0
        record["compile_s"] = 0.0            # nothing is compiled
        record.update(analyze(lowered, mesh, meta))
        record["ok"] = True
        del lowered
        gc.collect()
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-4000:]
    _write(out_dir, name, record)
    return record


def _write(out_dir, name, record):
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, name + ".json"), "w") as f:
        json.dump(record, f, indent=1)


def main(argv: Optional[list] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=ARTIFACT_DIR)
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--override", default="",
                    help="comma k=v RunConfig overrides (ints/bools/strs)")
    ap.add_argument("--mesh-device", choices=("cpu", "cuda"), default=None,
                    help="the fake mesh's device type (default: cuda "
                         "where a card is present, else cpu)")
    args = ap.parse_args(argv)

    overrides = {}
    for kv in filter(None, args.override.split(",")):
        k, v = kv.split("=")
        if v in ("True", "False"):
            v = v == "True"
        else:
            try:
                v = int(v)
            except ValueError:
                pass
        overrides[k] = v

    cells = []
    archs = list_archs() if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    for a in archs:
        for s in shapes:
            for mp in meshes:
                cells.append((a, s, mp))

    for a, s, mp in cells:
        mesh_tag = "2x16x16" if mp else "16x16"
        name = f"{a}__{s}__{mesh_tag}" + (f"__{args.tag}" if args.tag else "")
        path = os.path.join(args.out, name + ".json")
        if args.skip_existing and os.path.exists(path):
            with open(path) as f:
                if json.load(f).get("ok"):
                    print(f"[skip] {name}")
                    continue
        t0 = obs_clock.now()
        rec = run_cell(a, s, mp, args.out, overrides or None, args.tag,
                       args.mesh_device)
        status = "SKIP(" + rec.get("skip_reason", "")[:40] + ")" \
            if rec.get("skipped") else ("ok" if rec["ok"] else
                                        "FAIL " + rec.get("error", "")[:120])
        print(f"[{obs_clock.now()-t0:7.1f}s] {name}: {status}", flush=True)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Attribute one dry-run cell's wire bytes and flops to the code that
issues them.

Runs one cell of the port's dry-run (``repro_torch.launch.dryrun``) under
its operator counter, and charges each counted op to a site: the
innermost frame of the port's model, serving or training code on the
stack (``file:line function``), or, in the backward pass, the autograd
node that runs it (with ``--anomaly``, also the model frame of the
forward op that made the node).  Prints one JSON object: the cell's
totals, the wire bytes by (kind, mesh axis, site) and the flops by
(aten op, site), each list sorted by size and cut to ``--top``.

    python3 tools/dryrun_wire_sites.py --arch mamba2-780m --shape prefill_32k
        [--multi-pod] [--src PATH] [--top 30] [--anomaly]
        [--mesh-device cpu|cuda]

``--src`` names the ``src`` directory whose ``repro_torch`` runs (default:
this checkout's).  No card is needed.
"""
import argparse
import json
import os
import sys
import traceback
from collections import defaultdict

SITE_DIRS = ("repro_torch/models/", "repro_torch/serve/",
             "repro_torch/train/")


def _site_of(frames) -> str:
    for fr in reversed(frames):
        fn = fr.filename.replace(os.sep, "/")
        if any(d in fn for d in SITE_DIRS):
            short = fn[fn.index("repro_torch/"):]
            return f"{short}:{fr.lineno} {fr.name}"
    return ""


def main() -> None:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(here, "src"))
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--anomaly", action="store_true",
                    help="keep each backward node's forward traceback")
    ap.add_argument("--mesh-device", choices=("cpu", "cuda"), default=None)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    import torch
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.core import op_analysis
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import describe, make_production_mesh

    wire = defaultdict(float)
    flops = defaultdict(float)
    axes_of = {}
    orig = op_analysis.OpCounter._count

    def site() -> str:
        node = torch._C._current_autograd_node()
        if node is None:
            return _site_of(traceback.extract_stack()) or "other"
        fwd = ""
        tb = node.metadata.get("traceback_") if args.anomaly else None
        if tb:
            fwd = " <- " + _site_from_text(
                tb if isinstance(tb, str) else "".join(tb))
        return f"backward {node.name()}{fwd}"

    def counted(self, op, a, kw, out):
        cur = self._cur
        n0, f0 = len(cur.collectives), cur.flops
        orig(self, op, a, kw, out)
        new = cur.collectives[n0:]
        if not new and cur.flops == f0:
            return
        where = site()
        for c in new:
            axis = op_analysis.attribute_axes(
                op_analysis.OpCost(collectives=[c]), axes_of["mesh"])
            (ax,) = axis
            wire[(c.kind, ax, where)] += c.total_bytes
        if cur.flops != f0:
            flops[(op.base, where)] += cur.flops - f0

    op_analysis.OpCounter._count = counted
    cfg = get_config(args.arch)
    shape = SHAPES[args.shape]
    mesh = make_production_mesh(multi_pod=args.multi_pod,
                                device_type=args.mesh_device)
    axes_of["mesh"] = describe(mesh)
    run = dryrun._run_config(shape, arch=args.arch)
    torch.autograd.set_detect_anomaly(args.anomaly, check_nan=False)
    low, meta = dryrun.lower_cell(cfg, shape, mesh, run)
    rec = dryrun.analyze(low, mesh, meta)

    def top(d):
        rows = sorted(d.items(), key=lambda kv: -kv[1])[:args.top]
        return [list(k) + [v] for k, v in rows]
    print(json.dumps({
        "arch": args.arch, "shape": args.shape, "mesh": axes_of["mesh"],
        "mesh_device_type": mesh.device_type,
        "flops": rec["walker"]["flops"],
        "per_device_total": rec["memory"]["per_device_total"],
        "wire_by_axis": rec["walker"]["collective_by_axis"],
        "wire_by_kind": rec["walker"]["collective_bytes"],
        "analysis_s": rec["walker"]["analysis_s"],
        "wire_sites": top(wire), "flop_sites": top(flops)}, indent=1))


def _site_from_text(tb: str) -> str:
    """The innermost model frame of a traceback kept as text (anomaly
    mode's ``traceback_``: ``File "...", line n, in f`` lines)."""
    best = ""
    for line in tb.splitlines():
        line = line.strip()
        if not line.startswith("File "):
            continue
        try:
            path = line.split('"')[1].replace(os.sep, "/")
            lineno = line.split("line ")[1].split(",")[0]
            name = line.split(" in ")[-1]
        except IndexError:
            continue
        if any(d in path for d in SITE_DIRS):
            best = f"{path[path.index('repro_torch/'):]}:{lineno} {name}"
    return best


if __name__ == "__main__":
    main()

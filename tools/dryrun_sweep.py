#!/usr/bin/env python3
"""Sweep the port's dry-run one cell a process, each under a time limit.

Runs ``python -m repro_torch.launch.dryrun --arch A --shape S [--multi-pod]``
for every selected cell in a process of its own (its own fake process
group), ``--jobs`` at a time, each ended at ``--timeout`` seconds with its
whole process group.  Prints, and appends to ``--summary``, one JSON line
a cell: its status (``ok``, ``skip``, ``fail`` or ``unfinished``), its
wall seconds, and from its artifact the per-device flops, dot and HBM
bytes, ``per_device_total``, wire bytes by mesh axis and by kind, and the
analysis seconds.

    python3 tools/dryrun_sweep.py [--src PATH] [--arch A ...] [--shape S ...]
        [--mesh 16x16 2x16x16] [--jobs 3] [--timeout 900]
        [--out DIR] [--summary FILE] [--mesh-device cpu|cuda]

``--src`` names the ``src`` directory whose ``repro_torch`` runs (default:
this checkout's), so that two trees can be swept alike.  Each process has
``OMP_NUM_THREADS`` of 8 / ``--jobs``, at least 1.  No card is needed.

    python3 tools/dryrun_sweep.py --table SUMMARY [--before SUMMARY ...]

prints the cells of SUMMARY as a markdown table (a row an architecture and
shape; for each mesh the status and seconds, per-device flops,
``per_device_total`` in GB and wire bytes by mesh axis), and with
``--before``, a row of the same cells from the first of those summaries
that holds each, where any of their counts differ.
"""
import argparse
import json
import os
import signal
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ARCHS = ("qwen2-1.5b", "qwen2-7b", "qwen2-72b", "gemma2-2b",
         "llama4-scout-17b-a16e", "moonshot-v1-16b-a3b", "qwen2-vl-2b",
         "seamless-m4t-medium", "mamba2-780m", "hymba-1.5b")
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
MESHES = ("16x16", "2x16x16")


def run_one(src, out, arch, shape, mesh, timeout, threads, mesh_device):
    env = dict(os.environ, PYTHONPATH=src, OMP_NUM_THREADS=str(threads),
               MKL_NUM_THREADS=str(threads))
    env.pop("XLA_FLAGS", None)
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--out", out]
    if mesh == "2x16x16":
        cmd.append("--multi-pod")
    if mesh_device:
        cmd += ["--mesh-device", mesh_device]
    t0 = time.time()
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        log, _ = proc.communicate(timeout=timeout)
        finished = True
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        log, _ = proc.communicate()
        finished = False
    wall = time.time() - t0
    row = {"arch": arch, "shape": shape, "mesh": mesh, "wall_s": wall,
           "src": src}
    path = os.path.join(out, f"{arch}__{shape}__{mesh}.json")
    if not finished:
        row["status"] = "unfinished"
        return row
    if not os.path.exists(path):
        row.update(status="fail", error=log[-800:])
        return row
    with open(path) as f:
        rec = json.load(f)
    if rec.get("skipped"):
        row["status"] = "skip"
        return row
    if not rec.get("ok"):
        row.update(status="fail", error=rec.get("error", "")[:800])
        return row
    w, m = rec["walker"], rec["memory"]
    row.update(status="ok", flops=w["flops"], dot_bytes=w["dot_bytes"],
               hbm_bytes=w["hbm_bytes"],
               transcendentals=w["transcendentals"],
               per_device_total=m["per_device_total"],
               wire_by_axis=w["collective_by_axis"],
               wire_by_kind=w["collective_bytes"],
               analysis_s=w["analysis_s"],
               mesh_device_type=rec["mesh_device_type"])
    return row


def _rows(path):
    out = {}
    with open(path) as f:
        for line in f:
            r = json.loads(line)
            out[r["arch"], r["shape"], r["mesh"]] = r
    return out


def _cells(r):
    if r is None:
        return " | | | "
    if r["status"] != "ok":
        return f"{r['status']} {r['wall_s']:.0f} s | | | "
    w = r["wire_by_axis"]
    wire = " / ".join(f"{w[a]:.3g}" for a in ("pod", "data", "model")
                      if a in w)
    return (f"ok {r['wall_s']:.0f} s | {r['flops']:.4g} | "
            f"{r['per_device_total'] / 1e9:.2f} | {wire}")


KEYS = ("status", "flops", "dot_bytes", "hbm_bytes", "per_device_total",
        "wire_by_axis")


def table(summary, before) -> None:
    """The markdown table of ``summary``'s cells (``--table``): a row an
    (arch, shape), in the order of ARCHS and SHAPES, each mesh's status
    and seconds, flops, ``per_device_total`` in GB and wire bytes by mesh
    axis beside each other."""
    now = _rows(summary)
    old = [_rows(b) for b in before]
    print("| arch | shape | run | 16x16 | flops | GB | wire data / model "
          "| 2x16x16 | flops | GB | wire pod / data / model |")
    print("| --- | --- | --- | --- | --- | --- | --- | --- | --- | --- "
          "| --- |")
    pairs = sorted({k[:2] for k in now}, key=lambda k: (
        ARCHS.index(k[0]), SHAPES.index(k[1])))
    for a, sh in pairs:
        rows = [now.get((a, sh, m)) for m in MESHES]
        print(f"| {a} | {sh} | now | "
              + " | ".join(_cells(r) for r in rows) + " |")
        prev = [next((o[a, sh, m] for o in old if (a, sh, m) in o), None)
                for m in MESHES]
        if any(p is not None and r is not None and
               any(p.get(k) != r.get(k) for k in KEYS)
               for p, r in zip(prev, rows)):
            print("| | | before | "
                  + " | ".join(_cells(p) for p in prev) + " |")


def main() -> None:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(here, "src"))
    ap.add_argument("--arch", nargs="*", default=list(ARCHS))
    ap.add_argument("--shape", nargs="*", default=list(SHAPES))
    ap.add_argument("--mesh", nargs="*", default=list(MESHES))
    ap.add_argument("--jobs", type=int, default=3)
    ap.add_argument("--timeout", type=float, default=900.0)
    ap.add_argument("--out", default=None,
                    help="artifact directory (default: a folder beside "
                         "the summary)")
    ap.add_argument("--summary", default="dryrun_sweep.jsonl")
    ap.add_argument("--mesh-device", choices=("cpu", "cuda"), default=None)
    ap.add_argument("--table", default=None)
    ap.add_argument("--before", nargs="*", default=[])
    args = ap.parse_args()
    if args.table:
        table(args.table, args.before)
        return
    src = os.path.abspath(args.src)
    out = os.path.abspath(args.out or os.path.splitext(args.summary)[0])
    os.makedirs(out, exist_ok=True)
    threads = max(1, 8 // args.jobs)
    cells = [(a, s, m) for a in args.arch for s in args.shape
             for m in args.mesh]

    def one(cell):
        row = run_one(src, out, *cell, args.timeout, threads,
                      args.mesh_device)
        line = json.dumps(row)
        print(line, flush=True)
        with open(args.summary, "a") as f:
            f.write(line + "\n")
        return row
    with ThreadPoolExecutor(args.jobs) as pool:
        rows = list(pool.map(one, cells))
    bad = [r for r in rows if r["status"] in ("fail", "unfinished")]
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()

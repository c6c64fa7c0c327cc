#!/usr/bin/env python3
"""Drive the PyTorch port of Synapse on one CUDA card and check it.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It builds the port's CUDA kernels from ``src/repro_torch/csrc`` (into
``build/repro_torch``), then runs these phases, each printing JSON lines:

  device     the card (``nvidia-smi`` name and power limit), torch and CUDA
  build      the kernel library's build seconds and ptxas resource lines
  kernels    each kernel against its plain PyTorch version on the card, at
             several shapes, with its device time, its plain version's, a
             PyTorch library call's (each a CUDA graph's replay) and the
             bound: the datasheet rates, or L2's read rate where a pass's
             buffers fit in L2, read in this run by ``csrc/l2_probe.cu``
  main_path  the emulator end to end: a Qwen2-7B-sized ``serving_traffic``
             profile is stored, reloaded, and emulated with the fused
             ``"torch"`` backend and the per-sample ``"cuda"`` (kernel)
             backend; dispatches and kernel launches are checked against
             the schedule, the device's busy share is read from the
             launches and the device time of each, and ``predict`` is
             printed beside

Then one ``{"kernels": [...]}`` line and, last, one ``{"ok": true, ...}``
line.  Any failed check exits non-zero before the last line.  Without a
CUDA device, or without the package beside this script, it exits non-zero
and prints no result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM datasheet figures (NVIDIA): float32 outside the tensor cores,
# device memory, and the L2's size.  Bounds below are computed from these,
# and from L2's read rate where the bytes stay in L2 (the datasheet gives
# none; l2_read_rates measures it).
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BPS = 3.35e12
L2_BYTES = 50e6

BURN_TOL = 1e-5            # atol and rtol: exact float32 on both sides
BF16_RTOL = 1e-2           # the JAX package's own bf16 stream tolerance


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def event_ms(fn, reps: int, warmup: int = 2) -> float:
    """Milliseconds per call of ``fn`` from CUDA events around ``reps``
    back-to-back calls (after ``warmup`` calls)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, steps: int, reps: int = 5) -> float:
    """Device milliseconds per step of ``fn``, a chain of ``steps`` steps.
    ``fn`` is captured once in a CUDA graph and the graph replayed between
    CUDA events, so the host's rate of issuing calls does not enter: a
    kernel is timed against kernels."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                            # warm up: cuBLAS picks its kernels
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    ms = event_ms(graph.replay, reps, warmup=1) / steps
    del out
    return ms


def chain(body, x, steps: int):
    """``body`` applied ``steps`` times, starting from ``x``."""
    for _ in range(steps):
        x = body(x)
    return x


def l2_read_rates(torch) -> dict:
    """Bytes/s of ``csrc/l2_probe.cu`` reading a 16 and a 32 MiB float32
    buffer, both L2-resident, 100 times a launch."""
    from repro_torch.kernels import build
    lib = build.load()
    sink = torch.zeros(1, device="cuda")
    rates = {}
    for mib in (16, 32):
        n, reps = mib << 18, 100
        x = torch.ones(n, device="cuda")

        def probe():
            build.check(lib, lib.synapse_l2_read(
                x.data_ptr(), sink.data_ptr(), n, reps,
                torch.cuda.current_device(),
                torch.cuda.current_stream().cuda_stream), "l2_read")

        rates[f"{mib}MiB"] = n * 4 * reps / (event_ms(probe, 5) * 1e-3)
    return rates


def device_time(torch, fn):
    """Run ``fn`` under ``torch.profiler``: (wall seconds, seconds of CUDA
    kernels, the five kernels with the most time as [name, s, count])."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [(e.key, e.self_device_time_total / 1e6, e.count)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    kernels.sort(key=lambda k: -k[1])
    return wall, sum(k[1] for k in kernels), [list(k) for k in kernels[:5]]


def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    emit("device", nvidia_smi=card, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0])


def phase_build():
    from repro_torch.kernels import build
    existed = build.library_path().exists()
    t0 = time.perf_counter()
    build.load()
    seconds = time.perf_counter() - t0
    log = build.BUILD_DIR / build.LOG_NAME
    ptxas = []
    if log.exists():
        ptxas = [ln.strip() for ln in log.read_text().splitlines()
                 if "registers" in ln or "spill" in ln]
    emit("build", seconds=seconds, built=not existed,
         library=os.path.relpath(build.library_path(), ROOT), ptxas=ptxas)


def phase_kernels(torch, np):
    from repro_torch.kernels.compute_atom import kernel as ck, ref as cref
    from repro_torch.kernels.memory_atom import kernel as mk, ref as mref
    from repro_torch.kernels.memory_atom import ops as mops
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    rows = {}

    # -- burn_tile: exact float32 against the plain matmul chain ----------
    burn_err = 0.0
    for tile in (64, 128, 256):
        x = torch.from_numpy(
            (rng.standard_normal((tile, tile)) * 0.1).astype(np.float32)
        ).to(dev)
        for iters in (1, 17, 257):
            got = ck.burn_tile(x, iters=iters)
            want = cref.burn_tile(x, iters=iters)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            ok = bool(torch.isfinite(got).all()) and torch.allclose(
                got, want, atol=BURN_TOL, rtol=BURN_TOL)
            emit("kernels", kernel="burn_tile", tile=tile, iters=iters,
                 max_abs_err=err, ok=ok)
            if not ok:
                fail(f"burn_tile tile={tile} iters={iters}: max abs err "
                     f"{err} beyond atol=rtol={BURN_TOL}")
            burn_err = max(burn_err, err)

    # timed at the main path's shape: the atom's operand, tile 256, per
    # iteration (one launch), over a 1000-iteration burn captured whole
    tile, n_it = 256, 1000
    x = torch.eye(tile, dtype=torch.float32, device=dev) * 0.5
    bias = torch.full_like(x, 0.25)

    def library_step(y):
        return torch.addmm(bias, y, x, alpha=0.5)

    flops = cref.flops(tile, 1)
    nbytes = 3 * tile * tile * 4             # read y and x, write y
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BPS
    rows["burn_tile"] = {
        "name": "burn_tile", "route": "cuda",
        "source": "src/repro_torch/csrc/compute_atom.cu",
        "replaces": "src/repro/kernels/compute_atom/kernel.py:28",
        "max_abs_err": burn_err,
        "ms": graph_ms(lambda: ck.burn_tile(x, iters=n_it), n_it),
        "plain_ms": graph_ms(lambda: cref.burn_tile(x, iters=n_it), n_it),
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "bound_rate": "float32 FMA, datasheet",
        "library_ms": graph_ms(lambda: chain(library_step, x, n_it), n_it),
        "unit": "one iteration (one launch) at tile 256",
        "timing": "device time: CUDA graph of 1000 iterations",
    }

    # -- stream_pass: f32 bitwise, bf16 to the JAX package's rtol ---------
    stream_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for n in (1 << 22, 1 << 26):
            x = torch.from_numpy(
                rng.standard_normal(n).astype(np.float32)).to(dev, dtype)
            for passes in (1, 5):
                got = mops.stream(x, iters=passes, block_bytes=1 << 24)
                want = x
                for _ in range(passes):
                    want = mref.stream_pass(want)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                bitwise = torch.equal(got, want)
                ok = bitwise if dtype == torch.float32 else torch.allclose(
                    got.float(), want.float(), rtol=BF16_RTOL, atol=0.0)
                emit("kernels", kernel="stream_pass", dtype=str(dtype),
                     n=n, passes=passes, max_abs_err=err, bitwise=bitwise,
                     ok=ok)
                if not ok:
                    fail(f"stream_pass {dtype} n={n} passes={passes}: "
                         f"max abs err {err}")
                stream_err = max(stream_err, err)

    # timed per pass over a chain of passes captured whole; the main path's
    # shape is the atom's default 16 MiB float32 block, whose two ping-pong
    # buffers stay in L2, so L2's read rate bounds it; 256 MiB does not fit
    # and device memory's rate bounds it
    l2 = l2_read_rates(torch)
    l2_bps = max(l2.values())
    emit("kernels", probe="l2_read", bytes_per_s=l2)
    rates = {}
    for n in (1 << 22, 1 << 26):
        x = torch.ones(n, dtype=torch.float32, device=dev)
        reps = 200 if n == 1 << 22 else 20
        ms = graph_ms(lambda: mk.stream_passes(x, block=n, passes=reps), reps)
        nbytes = 2 * n * 4
        in_l2 = nbytes <= L2_BYTES
        mem_bps = l2_bps if in_l2 else PEAK_HBM_BPS
        t_bytes, t_ops = nbytes / mem_bps, n / PEAK_FP32_FLOPS
        rates[n] = {"bytes_per_pass": nbytes, "ms": ms,
                    "GB_per_s": nbytes / (ms * 1e-3) / 1e9,
                    "plain_ms": graph_ms(
                        lambda: chain(mref.stream_pass, x, reps), reps),
                    "library_ms": graph_ms(lambda: chain(
                        lambda y: torch.mul(y, 1.0000001), x, reps), reps),
                    "bound_ms": max(t_ops, t_bytes) * 1e3,
                    "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                    "bound_rate": ("L2 read rate of csrc/l2_probe.cu, this "
                                   "run" if in_l2 else "HBM, datasheet"),
                    "bound_GB_per_s": mem_bps / 1e9}
        rates[n]["share_of_bound"] = rates[n]["bound_ms"] / ms
        emit("kernels", kernel="stream_pass", rate_n=n, **rates[n])
    main = rates[1 << 22]
    rows["stream_pass"] = {
        "name": "stream_pass", "route": "cuda",
        "source": "src/repro_torch/csrc/memory_atom.cu",
        "replaces": "src/repro/kernels/memory_atom/kernel.py:23",
        "max_abs_err": stream_err,
        **{k: main[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                "bound_by", "bound_rate")},
        "unit": "one pass (one launch) over a 16 MiB float32 block",
        "timing": "device time: CUDA graph of 200 passes",
    }
    return rows


def phase_main_path(torch, rows):
    from repro_torch.core import (Emulator, HardwareSpec, ProfileStore,
                                  SegmentRunner, calibrate, get_spec,
                                  predict)
    from repro_torch.core.atoms import (compute_burn_body, compute_operand,
                                        memory_operand, memory_stream_body)
    from repro_torch.core.schedule import FusedSegment
    from repro_torch.kernels.compute_atom import kernel as ck
    from repro_torch.kernels.memory_atom import kernel as mk
    from repro_torch.scenarios import generate

    # Qwen2-7B's published sizes: 7.6e9 parameters in bf16, KV cache of
    # 28 layers x 4 KV heads x 128 x 2 (K and V) x 2 bytes a token
    profile = generate("serving_traffic", n_requests=2, prefill_tokens=128,
                       decode_tokens=16, n_params=7.6e9, bytes_per_param=2,
                       kv_bytes_per_token=57344, seed=0)
    with tempfile.TemporaryDirectory() as d:
        store = ProfileStore(d)
        store.add(profile)
        loaded = store.latest(profile.command, profile.tags)
    if loaded is None or loaded.totals != profile.totals:
        fail("profile did not round-trip through the store")
    totals = loaded.totals
    emit("main_path", step="profile", n_samples=len(loaded.samples),
         flops=totals.flops, hbm_bytes=totals.hbm_bytes)

    t0 = time.perf_counter()
    calib = calibrate(force=True)
    emit("main_path", step="calibrate", seconds=time.perf_counter() - t0,
         **json.loads(calib.to_json()))

    # device time of one iteration of each backend at the main path's shapes
    # (tile 256, 16 MiB block): the kernels' from the kernels phase, the
    # segment loop's torch ops' from a captured chain of iterations
    xc, xm = compute_operand(256, "cuda"), memory_operand(1 << 24, "cuda")
    per_iter_ms = {
        "cuda": (rows["burn_tile"]["ms"], rows["stream_pass"]["ms"]),
        "torch": (graph_ms(lambda: chain(compute_burn_body, xc, 100), 100),
                  graph_ms(lambda: chain(memory_stream_body, xm, 50), 50)),
    }
    emit("main_path", step="iteration_device_ms", **per_iter_ms)

    card = HardwareSpec(name="h100_sxm_fp32_datasheet",
                        peak_flops=PEAK_FP32_FLOPS, hbm_bw=PEAK_HBM_BPS,
                        ici_bw=0.0, ici_links=0, mem_per_chip=80e9)
    targets = {hw.name: predict(loaded, hw).ttc_max
               for hw in (get_spec(loaded.meta["ref_hw"]), card)}
    launches = {}
    for backend in ("torch", "cuda"):
        em = Emulator(calib=calib, backend=backend)
        table = [row for s in em.compile(loaded).segments
                 for row in s.table.tolist()]
        ci = sum(r[0] for r in table)
        mi = sum(r[1] for r in table)
        ck.launches = mk.launches = 0
        t0 = time.perf_counter()
        rep = em.emulate(loaded)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {"burn_tile": ck.launches, "stream_pass": mk.launches}
        if backend == "torch":
            want_mode, want_disp = "fused", 1
            want_launch = {"burn_tile": 0, "stream_pass": 0}
        else:
            want_mode = "per_sample"
            want_disp = sum((r[0] > 0) + (r[1] > 0) for r in table)
            want_launch = {"burn_tile": ci, "stream_pass": mi}
            launches = got
        # kernels run on one stream and do not overlap: the device is busy
        # for the iterations times the device time of each
        busy_s = (ci * per_iter_ms[backend][0]
                  + mi * per_iter_ms[backend][1]) / 1e3
        emit("main_path", step="emulate", backend=backend, mode=rep.mode,
             ttc_s=rep.ttc_s, wall_s=wall, n_samples=rep.n_samples,
             n_dispatches=rep.n_dispatches, compute_iters=ci,
             memory_iters=mi, launches=got, device_busy_s=busy_s,
             busy_share=busy_s / rep.ttc_s,
             achieved_flops_per_s=rep.consumed.flops / rep.ttc_s,
             achieved_bytes_per_s=rep.consumed.hbm_bytes / rep.ttc_s,
             predicted_ttc_s=targets)
        if rep.consumed != totals:
            fail(f"{backend}: consumed {rep.consumed} != totals {totals}")
        if rep.mode != want_mode or rep.n_dispatches != want_disp:
            fail(f"{backend}: mode {rep.mode} / {rep.n_dispatches} "
                 f"dispatches, want {want_mode} / {want_disp}")
        if got != want_launch or (backend == "cuda" and 0 in got.values()):
            fail(f"{backend}: kernel launches {got}, want {want_launch}")
        if rep.n_samples != len(loaded.samples):
            fail(f"{backend}: {rep.n_samples} samples replayed")

    # which kernels each backend launches: each replays a depth-cut profile
    # of the same widths (1 request of 8 prompt and 2 generated tokens) once
    # to warm up, then once under the profiler.  Its kernel time over wall
    # time is the cut run's, not the main path's (the once-per-sample sync
    # weighs more in a short run)
    cut = generate("serving_traffic", n_requests=1, prefill_tokens=8,
                   decode_tokens=2, n_params=7.6e9, bytes_per_param=2,
                   kv_bytes_per_token=57344, seed=0)
    for backend in ("torch", "cuda"):
        em = Emulator(calib=calib, backend=backend)
        em.emulate(cut)
        wall, busy, top = device_time(torch, lambda: em.emulate(cut))
        emit("main_path", step="trace_cut_run", backend=backend, wall_s=wall,
             kernel_s=busy, cut_run_busy_share=busy / wall, top_kernels=top)

    # the fused segment loop on the card agrees with the host on a small
    # table (tile 64, 256 KiB block)
    seg = FusedSegment(table=[[3, 2, 0], [0, 1, 0], [5, 0, 0]])
    on_card = SegmentRunner(tile=64, block_bytes=1 << 18).launch(seg)
    on_host = SegmentRunner(tile=64, block_bytes=1 << 18,
                            device="cpu").launch(seg)
    err = max((a.cpu() - b).abs().max().item()
              for a, b in zip(on_card, on_host))
    emit("main_path", step="segment_vs_host", max_abs_err=err)
    if not err <= 1e-5:
        fail(f"fused segment on the card differs from the host by {err}")

    for name, row in rows.items():
        row["launches"] = launches[name]


def main() -> None:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        import repro_torch
    except ImportError as e:
        fail(f"the port is not beside this script: {e}")
    if not os.path.abspath(repro_torch.__file__).startswith(
            os.path.join(ROOT, "src")):
        fail(f"imported repro_torch from {repro_torch.__file__}, not from "
             "this checkout")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase_device(torch)
    phase_build()
    rows = phase_kernels(torch, np)
    phase_main_path(torch, rows)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    for row in rows.values():
        missing = [k for k in keys if k not in row]
        if missing:
            fail(f"{row['name']}: kernels line lacks {missing}")
    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Drive the PyTorch port of Synapse on one CUDA card and check it.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It builds the port's CUDA kernels from ``src/repro_torch/csrc`` (into
``build/repro_torch``), then runs these phases, each printing JSON lines:

  device     the card (``nvidia-smi`` name and power limit), torch and CUDA
  build      the kernel library's build seconds and, for each kernel
             symbol, its ptxas register and spill lines and the HGMMA
             (tensor-core) instructions in its SASS; fails if the bf16
             flash kernel has none
  kernels    each kernel against its plain PyTorch version on the card, at
             several shapes, with its device time, its plain version's, a
             PyTorch library call's (each a CUDA graph's replay) and the
             bound: the datasheet rates, or L2's read rate where a pass's
             buffers fit in L2, read in this run by ``csrc/l2_probe.cu``;
             flash attention over the JAX package's test sweep, Gemma2's
             head dim and the serving shape
  main_path  the emulator end to end: a Qwen2-7B-sized ``serving_traffic``
             profile is stored, reloaded, and emulated with the fused
             ``"torch"`` backend and the per-sample ``"cuda"`` (kernel)
             backend; dispatches, burned iterations and kernel launches
             (one burn a compute leg) are checked against the schedule,
             the device's busy share is read from the
             launches and the device time of each, and ``predict`` is
             printed beside
  fleet      fleet emulation through ``run_fleet`` / ``emulate_many``:
             Qwen2-7B serving and training profiles (published widths,
             cut in tokens, steps and checkpoint bytes) with the other
             scenario families, on 2 threads of the ``"cuda"`` backend
             (consumed equals planned, burned iterations and kernel
             launches equal the schedule's), on warm pools of 1 and 2
             spawned worker processes on the card (reports equal the
             in-process replay; spawn-to-ready per worker), as a fork-join DAG
             (parents finish before children start; the critical path),
             and under a seeded chaos policy that kills each worker once
             (totals unchanged); the H100's fleet prediction beside the
             measured wall time.  Workers are spawned, never forked, and
             this script re-imported as their ``__mp_main__`` defines
             functions only
  service    the live traffic service: ``serving_traffic`` requests at
             Qwen2-7B's widths (the fleet phase's cut) arriving as a
             seeded Poisson stream at a warm 2-worker ``StandingFleet`` on
             the card, two sessions on one pool (every request's consumed
             equals its profile's totals; identical arrival timelines;
             queue wait, replay and latency quantiles), the same stream
             through ``run_load`` under a chaos kill (deaths, respawns,
             MTTR in the faulted SLO windows), a load run over HTTP on
             port 0 (``/run``, ``/metrics``, the run's trace), a host agent
             (``python -m repro_torch.fleet.agent``) replaying the fleet
             phase's jobs through the remote executor bit for bit like the
             in-process replay, and the scenarios CLI as a subprocess;
             every trace validates with one replay span a dispatch
  serve      the dense zoo's serving path: Qwen2-7B's widths cut to 2
             layers in float32, the flash kernel against dense attention
             (final hidden states, greedy tokens); then the full model in
             bf16 (weights made on the card from a seed) serving 4
             requests under the ``RuntimeProfiler`` (prefill and decode
             times, tokens/s, peak memory, flash launches = layers x
             waves), traced prefill and decode steps, the profile stored,
             reloaded and replayed on the ``"cuda"`` emulator backend, and
             a full-depth report of the kernel against dense attention

Then one ``{"kernels": [...]}`` line and, last, one ``{"ok": true, ...}``
line.  Any failed check exits non-zero before the last line.  Without a
CUDA device, or without the package beside this script, it exits non-zero
and prints no result.
"""
from __future__ import annotations

import json
import math
import os
import re
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
PEAK_BF16_FLOPS = 989e12       # tensor cores, dense
PEAK_HBM_BPS = 3.35e12
L2_BYTES = 50e6

BURN_TOL = 1e-5            # atol and rtol: exact float32 on both sides
BF16_RTOL = 1e-2           # the JAX package's own bf16 stream tolerance
# the bf16 flash kernel of csrc/flash_attention_sm90.cu, in mangled symbols
BF16_FLASH_SYMBOL = "fa_sm90"
# flash attention, atol and rtol: the JAX package's own (tests/test_kernels.py)
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# final hidden states of the depth-cut model, "cuda" against "full" in
# float32: the two sum in other orders (1.7e-5 seen on the CPU at the
# reduced size); 1e-4 leaves room for 512 tokens at full width
DEPTH_CUT_TOL = 1e-4
# burn_tile cases (tile, iterations); the tiles that the C function runs in
# one launch (csrc/compute_atom.cu), and others that run one launch an
# iteration
BURN_ONE_LAUNCH_TILES = (64, 128, 256)
BURN_CASES = [(t, (1, 17, 257)) for t in BURN_ONE_LAUNCH_TILES] + [
    (32, (1, 17)), (320, (1, 17))]

# (BH, BKV, Sq, Sk, hd, block_q, block_kv, causal, window, softcap): the
# JAX package's SWEEP (tests/test_kernels.py), Gemma2's head dim with its
# window and softcap, then unequal lengths and windows that leave rows with
# no visible key (the kernel's path that visits every kv tile)
FLASH_CASES = [
    (2, 2, 64, 64, 16, 16, 16, True, None, None),
    (2, 2, 64, 64, 16, 32, 16, True, 9, None),
    (2, 2, 64, 64, 16, 16, 32, True, None, 30.0),
    (4, 2, 32, 32, 8, 8, 8, True, None, None),
    (3, 1, 48, 48, 32, 16, 16, False, None, None),
    (2, 2, 128, 128, 64, 64, 32, True, 40, 25.0),
    (8, 4, 512, 512, 256, 512, 512, True, 128, 50.0),
    (4, 2, 100, 37, 64, 100, 37, True, None, None),      # Sq > Sk
    (2, 1, 24, 40, 16, 8, 8, False, 7, None),            # Sq < Sk
    (2, 1, 37, 100, 128, 37, 100, True, 16, 30.0),       # Sq < Sk, window
    (4, 2, 40, 24, 16, 8, 8, True, 5, None),             # rows 28.. see none
    (2, 1, 96, 40, 256, 96, 40, True, 20, None),         # rows 60.. see none
    (2, 2, 64, 64, 32, 16, 16, True, 0, None),           # window 0: no row
    (2, 2, 64, 64, 32, 16, 16, False, 0, 30.0),          # window 0, not causal
]
# the serving shape in bfloat16: besides the elementwise 2e-2, the error's
# RMS over the output's RMS (outputs average ~1000 values, so their typical
# size is ~0.05 and 2e-2 alone is loose there)
FLASH_SERVE_REL_RMS = 1e-2
# Qwen2-7B's published sizes (src/repro/configs/qwen2_7b.py): 7.6e9
# parameters, bf16 weights, a KV cache of 28 layers x 4 KV heads x 128 x 2
# (K and V) x 2 bytes a token
QWEN2_7B_PARAMS = 7.6e9
QWEN2_7B_SERVING = dict(n_params=QWEN2_7B_PARAMS, bytes_per_param=2,
                        kv_bytes_per_token=57344)
# device bytes a training step moves per parameter: bf16 weights and
# gradients (2 + 2), f32 Adam m, v and master copy (4 + 4 + 4)
QWEN2_7B_TRAIN_BYTES_PER_PARAM = 16
# the fleet phase's cuts: depth only (tokens, steps, requests, checkpoint
# bytes), never a width; a checkpoint of 1 GiB, not the 15.2 GB of bf16
# weights, keeps the phase near a minute
FLEET_CUTS = {
    "serving_traffic": {"n_requests": 1, "prefill_tokens": 32,
                        "decode_tokens": 4},
    "training_scan": {"tokens_per_step": 16, "n_steps": 2,
                      "ckpt_bytes": float(1 << 30)},
}
# the serving shape: Qwen2-7B's prefill of 4 prompts of 2048 tokens
SERVE_B, SERVE_S, SERVE_HQ, SERVE_HK, SERVE_HD = 4, 2048, 28, 4, 128
SERVE_PROMPTS = (2048, 1536, 1024, 512)
SERVE_NEW_TOKENS = 16


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


def repeat(fn, steps: int):
    """``fn()`` called ``steps`` times; the last result."""
    for _ in range(steps):
        out = fn()
    return out


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


def kernel_resources(log_text: str) -> dict:
    """ptxas's register and spill lines of each kernel symbol, from the
    ``-Xptxas -v`` output in the build log."""
    out, name = {}, None
    for ln in log_text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)'?", ln)
        if m:
            name = m.group(1)
        elif name and re.search(r"Used \d+ registers|bytes spill", ln):
            out.setdefault(name, []).append(ln.strip())
    return out


def sass_hgmma_counts(library) -> dict:
    """HGMMA instructions in each kernel's SASS (``cuobjdump -sass``)."""
    from repro_torch.kernels import build
    tool = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    res = subprocess.run([tool, "-sass", str(library)], capture_output=True,
                         text=True, timeout=300)
    if res.returncode != 0:
        fail(f"cuobjdump -sass failed: {res.stderr.strip()[-2000:]}")
    counts, name = {}, None
    for ln in res.stdout.splitlines():
        m = re.match(r"\s*Function : (\S+)", ln)
        if m:
            name = m.group(1)
            counts[name] = 0
        elif name and "HGMMA" in ln:
            counts[name] += 1
    return counts


def phase_build():
    from repro_torch.kernels import build
    existed = build.library_path().exists()
    t0 = time.perf_counter()
    build.load()
    seconds = time.perf_counter() - t0
    log = build.BUILD_DIR / build.LOG_NAME
    text = log.read_text() if log.exists() else ""
    resources = kernel_resources(text)
    hgmma = sass_hgmma_counts(build.library_path())
    kernels = {name: {"ptxas": resources.get(name, []), "hgmma": n}
               for name, n in sorted(hgmma.items())}
    emit("build", seconds=seconds, built=not existed,
         library=os.path.relpath(build.library_path(), ROOT),
         kernels=kernels, notes=[ln.strip() for ln in text.splitlines()
                                 if re.search(r"(?i)warning|\(C\d{4}\)", ln)])
    # the bf16 flash kernel's template instances must run on the tensor
    # cores
    tensor_core = {k: n for k, n in hgmma.items() if BF16_FLASH_SYMBOL in k}
    if not tensor_core or 0 in tensor_core.values():
        fail(f"the bf16 flash kernel has no HGMMA instruction: "
             f"{tensor_core or 'no symbol ' + BF16_FLASH_SYMBOL}")


def phase_kernels(torch, np):
    from repro_torch.kernels.compute_atom import kernel as ck, ref as cref
    from repro_torch.kernels.memory_atom import kernel as mk, ref as mref
    from repro_torch.kernels.memory_atom import ops as mops
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    rows = {}

    # -- burn_tile: exact float32 against the plain matmul chain; tiles 64,
    # 128 and 256 run a burn in one cluster launch, 32 and 320 one launch
    # an iteration (the C function chooses by shape)
    burn_err = 0.0
    for tile, iters_list in BURN_CASES:
        x = torch.from_numpy(
            (rng.standard_normal((tile, tile)) * 0.1).astype(np.float32)
        ).to(dev)
        for iters in iters_list:
            before = (ck.launches, ck.iterations)
            got = ck.burn_tile(x, iters=iters)
            counted = (ck.launches - before[0], ck.iterations - before[1])
            want = cref.burn_tile(x, iters=iters)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            ok = bool(torch.isfinite(got).all()) and torch.allclose(
                got, want, atol=BURN_TOL, rtol=BURN_TOL)
            one_launch = tile in BURN_ONE_LAUNCH_TILES
            emit("kernels", kernel="burn_tile", tile=tile, iters=iters,
                 launches=counted[0], max_abs_err=err, ok=ok)
            if not ok:
                fail(f"burn_tile tile={tile} iters={iters}: max abs err "
                     f"{err} beyond atol=rtol={BURN_TOL}")
            if counted != (1 if one_launch else iters, iters):
                fail(f"burn_tile tile={tile} iters={iters}: counted "
                     f"(launches, iterations) {counted}")
            burn_err = max(burn_err, err)

    # timed at the main path's shape: the atom's operand, tile 256, per
    # iteration, over a 1000-iteration burn (one launch) captured whole
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
        "unit": "one iteration of a 1000-iteration burn (one launch) at "
                "tile 256",
        "timing": "device time: CUDA graph of the one launch; plain and "
                  "library: of 1000 iterations",
    }
    rows["burn_tile"]["share_of_bound"] = (rows["burn_tile"]["bound_ms"]
                                           / rows["burn_tile"]["ms"])
    emit("kernels", kernel="burn_tile", **{
        k_: v_ for k_, v_ in rows["burn_tile"].items() if k_ != "name"})

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
    rows["flash_attention"] = phase_flash(torch, np, rng)
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


def phase_flash(torch, np, rng):
    """flash_attention against its plain version on the card, then timed
    at the serving shape beside scaled_dot_product_attention (a yardstick
    the port never calls)."""
    from repro_torch.kernels.flash_attention import kernel as fk, ref as fref
    dev = torch.device("cuda")
    flash_err = 0.0
    for dtype_name, tol in FLASH_TOL.items():
        dtype = getattr(torch, dtype_name)
        for case in FLASH_CASES:
            BH, BKV, Sq, Sk, hd, bq, bkv, causal, window, softcap = case
            q, k, v = (torch.from_numpy(rng.standard_normal(
                (n, S, hd)).astype(np.float32)).to(dev, dtype)
                for n, S in ((BH, Sq), (BKV, Sk), (BKV, Sk)))
            kw = dict(causal=causal, window=window, softcap=softcap,
                      group=BH // BKV)
            got = fk.flash_attention(q, k, v, block_q=bq, block_kv=bkv, **kw)
            want = fref.flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            ok = got.dtype == dtype and torch.allclose(
                got.float(), want.float(), atol=tol, rtol=tol)
            emit("kernels", kernel="flash_attention", dtype=str(dtype),
                 case=list(case), max_abs_err=err, tol=tol, ok=ok)
            if not ok:
                fail(f"flash_attention {dtype} {case}: max abs err {err} "
                     f"beyond atol=rtol={tol}")
            flash_err = max(flash_err, err)

    B, S, Hq, Hk, hd = SERVE_B, SERVE_S, SERVE_HQ, SERVE_HK, SERVE_HD
    G = Hq // Hk
    q32 = torch.randn(B * Hq, S, hd, device=dev)
    k32 = torch.randn(B * Hk, S, hd, device=dev)
    v32 = torch.randn(B * Hk, S, hd, device=dev)
    for dtype_name, tol in FLASH_TOL.items():
        dtype = getattr(torch, dtype_name)
        q, k, v = (t.to(dtype) for t in (q32, k32, v32))
        got = fk.flash_attention(q, k, v, block_q=512, block_kv=1024,
                                 group=G).float()
        want = fref.flash_attention(q, k, v, group=G).float()
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        rel_rms = ((got - want).square().mean().sqrt()
                   / want.square().mean().sqrt()).item()
        ok = torch.allclose(got, want, atol=tol, rtol=tol)
        if dtype == torch.bfloat16:
            ok = ok and rel_rms < FLASH_SERVE_REL_RMS
        emit("kernels", kernel="flash_attention", dtype=str(dtype),
             case="serving shape", max_abs_err=err, tol=tol,
             rel_rms_err=rel_rms, ok=ok)
        if not ok:
            fail(f"flash_attention {dtype} at the serving shape: max abs err "
                 f"{err}, error RMS / output RMS {rel_rms}")
        flash_err = max(flash_err, err)
        del got, want
    q, k, v = (t.to(torch.bfloat16) for t in (q32, k32, v32))
    del q32, k32, v32

    # the library call: k and v expanded to the query heads before capture
    qs = q.view(B, Hq, S, hd)
    ks = k.view(B, Hk, S, hd).repeat_interleave(G, dim=1)
    vs = v.view(B, Hk, S, hd).repeat_interleave(G, dim=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    n_it = 20
    ms = graph_ms(lambda: repeat(lambda: fk.flash_attention(
        q, k, v, block_q=512, block_kv=1024, group=G), n_it), n_it)
    plain_ms = graph_ms(lambda: repeat(lambda: fref.flash_attention(
        q, k, v, group=G), 3), 3)
    library_ms = graph_ms(lambda: repeat(lambda: sdpa(
        qs, ks, vs, is_causal=True), n_it), n_it)
    flops = fref.flops(B * Hq, S, S, hd, causal=True)
    nbytes = 2 * (2 * B * Hq * S * hd + 2 * B * Hk * S * hd)  # q,out; k,v
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BPS
    row = {
        "name": "flash_attention", "route": "cuda",
        # the bf16 kernel timed here; float32 runs the SIMT kernel of
        # csrc/flash_attention.cu, which also holds the C entry point
        "source": "src/repro_torch/csrc/flash_attention_sm90.cu",
        "float32_source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:75",
        "max_abs_err": flash_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "bound_rate": "bf16 tensor cores dense, datasheet",
        "bound_bytes_ms": t_bytes * 1e3, "flops": flops,
        "library_ms": library_ms,
        "library": "scaled_dot_product_attention, k/v expanded to 28 heads",
        "unit": "one launch: causal prefill attention, B 4, S 2048, "
                "28 query and 4 KV heads, hd 128, bf16",
        "timing": "device time: CUDA graph of 20 launches (plain: 3)",
    }
    row["achieved_tflops"] = flops / (ms * 1e-3) / 1e12
    row["share_of_bound"] = row["bound_ms"] / ms
    emit("kernels", kernel="flash_attention", **{
        k_: v_ for k_, v_ in row.items() if k_ != "name"})
    return row


def phase_main_path(torch, rows):
    """The emulator end to end on a Qwen2-7B-sized profile; returns the
    calibration and the device milliseconds of one iteration of each
    backend's compute and memory legs, which the fleet phase reuses."""
    from repro_torch.core import (H100_SXM, Emulator, ProfileStore,
                                  SegmentRunner, calibrate, get_spec,
                                  predict)
    from repro_torch.core.atoms import (compute_burn_body, compute_operand,
                                        memory_operand, memory_stream_body)
    from repro_torch.core.schedule import FusedSegment
    from repro_torch.kernels.compute_atom import kernel as ck
    from repro_torch.kernels.memory_atom import kernel as mk
    from repro_torch.scenarios import generate

    profile = generate("serving_traffic", n_requests=2, prefill_tokens=128,
                       decode_tokens=16, seed=0, **QWEN2_7B_SERVING)
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

    targets = {hw.name: predict(loaded, hw).ttc_max
               for hw in (get_spec(loaded.meta["ref_hw"]), H100_SXM)}
    launches = {}
    for backend in ("torch", "cuda"):
        em = Emulator(calib=calib, backend=backend)
        table = [row for s in em.compile(loaded).segments
                 for row in s.table.tolist()]
        ci = sum(r[0] for r in table)
        mi = sum(r[1] for r in table)
        ck.launches = ck.iterations = mk.launches = 0
        t0 = time.perf_counter()
        rep = em.emulate(loaded)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {"burn_tile": ck.launches, "stream_pass": mk.launches}
        burned = ck.iterations
        if backend == "torch":
            want_mode, want_disp = "fused", 1
            want_launch = {"burn_tile": 0, "stream_pass": 0}
            want_burned = 0
        else:
            want_mode = "per_sample"
            want_disp = sum((r[0] > 0) + (r[1] > 0) for r in table)
            # one burn launch a compute leg, burning the leg's iterations
            want_launch = {"burn_tile": compute_legs(table),
                           "stream_pass": mi}
            want_burned = ci
            launches = got
            rows["burn_tile"]["iterations"] = burned
        # kernels run on one stream and do not overlap: the device is busy
        # for the iterations times the device time of each
        busy_s = (ci * per_iter_ms[backend][0]
                  + mi * per_iter_ms[backend][1]) / 1e3
        emit("main_path", step="emulate", backend=backend, mode=rep.mode,
             ttc_s=rep.ttc_s, wall_s=wall, n_samples=rep.n_samples,
             n_dispatches=rep.n_dispatches, compute_iters=ci,
             compute_legs=compute_legs(table), burned_iters=burned,
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
        if burned != want_burned:
            fail(f"{backend}: burned {burned} iterations, want {want_burned}")
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
                   decode_tokens=2, seed=0, **QWEN2_7B_SERVING)
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
        if name in launches:
            row["launches"] = launches[name]
    return calib, per_iter_ms


def fleet_jobs():
    """The fleet phase's job set as ``run_fleet`` jobs: Qwen2-7B serving
    and training at its published widths, and the other families at their
    registered defaults."""
    train_tokens = FLEET_CUTS["training_scan"]["tokens_per_step"]
    return [
        ("serving_traffic", dict(QWEN2_7B_SERVING, seed=0,
                                 **FLEET_CUTS["serving_traffic"])),
        ("training_scan", dict(
            n_steps=FLEET_CUTS["training_scan"]["n_steps"],
            flops_per_step=6 * QWEN2_7B_PARAMS * train_tokens,
            hbm_per_step=QWEN2_7B_PARAMS * QWEN2_7B_TRAIN_BYTES_PER_PARAM,
            ckpt_every=FLEET_CUTS["training_scan"]["n_steps"],
            ckpt_bytes=FLEET_CUTS["training_scan"]["ckpt_bytes"])),
        ("fanout_straggler", {}), ("retry_storm", {}),
        ("mixed_fleet", {"seed": 1}), ("mixed_fleet", {"seed": 2}),
    ]


def planned_legs(em, profile):
    """(compute iterations, memory iterations, compute legs) that the
    kernel backend replays for ``profile``: the compiled table's rows, and
    each barrier step's sample once for each of its ``count`` (storage
    runs replay sample by sample)."""
    from repro_torch.core.schedule import FusedSegment
    ci = mi = legs = 0
    for step in em.compile(profile).steps:
        if isinstance(step, FusedSegment):
            rows = [(r[0], r[1], 1) for r in step.table.tolist()]
        else:
            r = step.resources
            rows = [(em.compute.iters_for(r.flops),
                     em.memory.iters_for(r.hbm_bytes), step.count)]
        for c, m, n in rows:
            ci, mi, legs = ci + c * n, mi + m * n, legs + (c > 0) * n
    return ci, mi, legs


def phase_fleet(torch, calib, per_iter_ms):
    """Fleet emulation on the card: the job set of ``fleet_jobs`` through
    ``run_fleet`` on 2 threads of the ``"cuda"`` kernel backend, on warm
    pools of 1 and 2 worker processes (``"torch"`` backend) against the
    same profiles replayed in this process, as a fork-join ``WorkloadDag``,
    and
    under a seeded chaos policy that kills each worker once; then the
    H100's ``predict_fleet`` row beside the measured wall time."""
    from repro_torch.core import H100_SXM, Emulator
    from repro_torch.fleet import (BundleTiming, ChaosPolicy, FleetConfig,
                                   ProcessFleet, critical_path,
                                   run_process_fleet)
    from repro_torch.kernels.compute_atom import kernel as ck
    from repro_torch.kernels.memory_atom import kernel as mk
    from repro_torch.obs import Event
    from repro_torch.scenarios import fork_join, generate, run_fleet

    started = time.perf_counter()
    jobs = fleet_jobs()
    profiles = [generate(name, **kw) for name, kw in jobs]
    emit("fleet", step="jobs", reduced=FLEET_CUTS, jobs=[
        {"scenario": name, "n_samples": len(p.samples),
         "flops": p.totals.flops, "hbm_bytes": p.totals.hbm_bytes,
         "storage_write_bytes": p.totals.storage_write_bytes}
        for (name, _), p in zip(jobs, profiles)])
    card = torch.cuda.get_device_name(0)

    # 1. thread fleet on the kernel backend
    em = Emulator(calib=calib, backend="cuda")
    legs = [planned_legs(em, p) for p in profiles]
    ci, mi, cl = (sum(x[i] for x in legs) for i in range(3))
    ck.launches = ck.iterations = mk.launches = 0
    res = run_fleet(jobs, config=FleetConfig.thread(max_workers=2),
                    emulator=em, hw=H100_SXM)
    torch.cuda.synchronize()
    got = {"burn_tile": ck.launches, "stream_pass": mk.launches}
    burned = ck.iterations
    fleet = res.fleet
    busy_s = (ci * per_iter_ms["cuda"][0] + mi * per_iter_ms["cuda"][1]) / 1e3
    emit("fleet", step="thread_cuda", workers=fleet.max_workers,
         wall_s=fleet.wall_s, serial_s=fleet.serial_s,
         speedup=fleet.speedup, compute_iters=ci, compute_legs=cl,
         burned_iters=burned, memory_iters=mi, launches=got,
         device_busy_s=busy_s, busy_share=busy_s / fleet.wall_s,
         cache_stats=fleet.cache_stats)
    for (name, _), r, p in zip(jobs, res.results, profiles):
        if r.report.consumed != p.totals or r.profile.totals != p.totals:
            fail(f"thread fleet: {name} consumed {r.report.consumed}, "
                 f"planned {p.totals}")
    if burned != ci:
        fail(f"thread fleet: burned {burned} iterations, want {ci}")
    if got != {"burn_tile": cl, "stream_pass": mi} or 0 in got.values():
        fail(f"thread fleet: kernel launches {got}, want {cl} burns and "
             f"{mi} streams")
    pred = res.predictions
    emit("fleet", step="predict", hw=pred["hw"],
         predicted_serial_s=pred["serial_s"],
         predicted_concurrent_lower_s=pred["concurrent_lower_s"],
         dominant=pred["dominant_total"], measured_wall_s=fleet.wall_s)
    if pred["hw"] != H100_SXM.name or pred["n_profiles"] != len(jobs):
        fail(f"fleet prediction is for {pred['hw']}, {pred['n_profiles']} "
             "profiles")

    # 2. warm pools of 1 and 2 worker processes on the fused "torch"
    # backend, against the same profiles replayed back to back here
    em = Emulator(calib=calib, backend="torch")
    t0 = time.perf_counter()
    refs = [em.emulate(p, fused=True) for p in profiles]
    torch.cuda.synchronize()
    in_process_s = time.perf_counter() - t0
    em.storage.cleanup()
    emit("fleet", step="in_process_torch", wall_s=in_process_s,
         ttc_s=[r.ttc_s for r in refs])
    for n in (1, 2):
        spec = FleetConfig.process(max_workers=n).worker_spec(
            em.spec(), device=str(em.device))
        spawned = time.monotonic()
        with ProcessFleet(n, spec) as pool:
            infos = pool.warmup(timeout=300.0)
            # without heartbeats a worker's last_seen is stamped when its
            # ready message arrives
            spawn_to_ready = sorted(p.last_seen - spawned
                                    for p in pool._peers)
            warm = run_process_fleet(em, profiles, fleet=pool)
        emit("fleet", step="process_torch", workers=warm.max_workers,
             spawn_to_ready_s=spawn_to_ready, ready=infos,
             wall_s=warm.wall_s, serial_s=warm.serial_s,
             speedup=warm.speedup, in_process_s=in_process_s,
             in_process_over_wall=in_process_s / warm.wall_s,
             ttc_s=[r.ttc_s for r in warm.reports])
        if [i["device"] for i in infos] != [card] * n:
            fail(f"process fleet workers run on {infos}, not on {card}")
        for r, ref in zip(warm.reports, refs):
            if r.mode != "fused" or r.consumed != ref.consumed:
                fail(f"process fleet: {r.command} consumed {r.consumed} "
                     f"({r.mode}), in-process {ref.consumed}")
        if warm.n_replayed != len(profiles):
            fail(f"process fleet replayed {warm.n_replayed} profiles")

    # 3. a fork-join DAG of the same profiles through the process fleet
    dag = fork_join(profiles[0], profiles[1:-1], profiles[-1])
    rep = em.emulate_many(dag, config=FleetConfig.process(max_workers=2))
    events = [Event.from_dict(e) for e in rep.obs["events"]]
    stamps = {}
    for e in events:
        if e.kind in ("enqueue", "dispatch", "done"):
            stamps.setdefault(e.get("idx"), {}).setdefault(
                e.kind, []).append(e.t)
    timings = {}
    for i, parents in dag.parents_map.items():
        s = stamps.get(i, {})
        if len(s.get("done", ())) != 1:
            fail(f"dag: node {i} finished {len(s.get('done', ()))} times")
        for p in parents:
            if min(s["dispatch"]) < stamps[p]["done"][0]:
                fail(f"dag: node {i} started before its parent {p} ended")
        timings[i] = BundleTiming(
            enqueued=min(s["enqueue"]), dispatched=max(s["dispatch"]),
            done=s["done"][0], queue_s=0.0,
            replay_s=s["done"][0] - max(s["dispatch"]), attempts=1, ok=True)
    # the same analysis over the recorder's stamps, which are taken
    # microseconds from the scheduler's own
    cp = critical_path(dag.parents_map, timings)
    emit("fleet", step="dag", n_nodes=rep.dag["n_nodes"],
         n_edges=rep.dag["n_edges"], critical_nodes=rep.dag["critical_nodes"],
         critical_path_s=rep.dag["critical_path_s"],
         makespan_s=rep.dag["makespan_s"],
         parallelism=rep.dag["parallelism"], wall_s=rep.wall_s,
         from_events=cp["critical_path_s"])
    for r, p in zip(rep.reports, dag.profiles()):
        if r.consumed != p.totals:
            fail(f"dag: {r.command} consumed {r.consumed}, want {p.totals}")
    if rep.n_replayed != len(dag) or \
            (rep.dag["n_nodes"], rep.dag["n_edges"]) != (len(dag),
                                                         dag.n_edges) or \
            rep.dag["critical_nodes"] != cp["critical_nodes"] or \
            abs(rep.dag["critical_path_s"] - cp["critical_path_s"]) > 1e-3:
        fail(f"dag: report {rep.dag}, from the recorder's stamps {cp}")

    # 4. the pool of check 2 under chaos: each worker dies once, at its
    # third bundle, with its CUDA context live, and is respawned
    chaos = run_fleet(jobs, config=FleetConfig.process(
        max_workers=2, chaos=ChaosPolicy(kill_every=3, max_faults=1,
                                         seed=0)), emulator=em, hw=H100_SXM)
    rec = chaos.fleet.recovery
    emit("fleet", step="chaos", wall_s=chaos.fleet.wall_s,
         worker_deaths=rec["worker_deaths"], requeued=rec["requeued"],
         respawns=chaos.fleet.cache_stats["respawns"],
         mttr_s=rec["mttr_s"], lost_replay_s=rec["lost_replay_s"],
         requeue_latency_s=rec["requeue_latency_s"])
    if rec["worker_deaths"] < 1:
        fail("chaos: no worker died")
    if chaos.fleet.totals != warm.totals:
        fail(f"chaos: totals {chaos.fleet.totals} != {warm.totals}")
    emit("fleet", step="done", seconds=time.perf_counter() - started)
    return profiles, refs


def quantiles(values):
    """p50/p99/p999 of ``values`` through the service's latency sketch,
    the same estimator the SLO report's latencies come from."""
    from repro_torch.service import LatencySketch
    sk = LatencySketch()
    for v in values:
        sk.add(max(float(v), 0.0))
    return {"p50": sk.quantile(0.5), "p99": sk.quantile(0.99),
            "p999": sk.quantile(0.999), "count": sk.count}


def replay_spans_match(events, name):
    """The trace of a run's events passes ``validate_trace`` and holds one
    replay span a dispatch; returns the trace."""
    from repro_torch.obs import Event, to_chrome_trace, validate_trace
    evs = [e if isinstance(e, Event) else Event.from_dict(e) for e in events]
    trace = to_chrome_trace(evs)
    try:
        validate_trace(trace)
    except ValueError as e:
        fail(f"{name}: trace does not validate: {e}")
    spans = sum(t.get("cat") == "replay" and t["ph"] == "X"
                for t in trace["traceEvents"])
    dispatches = sum(e.kind == "dispatch" and e.scope == "coordinator"
                     for e in evs)
    if spans != dispatches or spans == 0:
        fail(f"{name}: {spans} replay spans for {dispatches} dispatches")
    return trace


def src_env():
    """The environment of a subprocess that must find the package."""
    old = os.environ.get("PYTHONPATH", "")
    return dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")
                + (os.pathsep + old if old else ""))


def phase_service(torch, calib, fleet_profiles, fleet_refs):
    """The live traffic service on the card: ``serving_traffic`` requests
    at Qwen2-7B's widths (the fleet phase's cut) arriving as a seeded
    Poisson stream at a warm ``StandingFleet`` of 2 workers (two sessions
    on one pool), the same stream under a chaos kill through ``run_load``,
    the HTTP surface on port 0, a host agent serving the fleet phase's
    jobs through ``emulate_many`` on the remote executor, and the
    scenarios CLI as a subprocess.  Workers replay the fused ``"torch"``
    path, so no kernel is launched here."""
    import urllib.request

    from repro_torch.core import Emulator, ReportFold
    from repro_torch.fleet import ChaosPolicy, FleetConfig
    from repro_torch.kernels.compute_atom import kernel as ck
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.memory_atom import kernel as mk
    from repro_torch.obs import Event, parse_promtext, validate_trace
    from repro_torch.obs import now as obs_now
    from repro_torch.scenarios import generate
    from repro_torch.service import PoissonArrivals, StandingFleet, run_load
    from repro_torch.service.http import make_server

    started = time.perf_counter()
    card = torch.cuda.get_device_name(0)
    params = dict(QWEN2_7B_SERVING, seed=0, **FLEET_CUTS["serving_traffic"])
    profile = generate("serving_traffic", **params)
    em = Emulator(calib=calib, backend="torch")
    t0 = time.perf_counter()
    ref = em.emulate(profile, fused=True)
    emit("service", step="traffic", scenario="serving_traffic",
         params=params, reduced=FLEET_CUTS["serving_traffic"],
         n_samples=len(profile.samples), flops=profile.totals.flops,
         hbm_bytes=profile.totals.hbm_bytes,
         in_process_replay_s=time.perf_counter() - t0)
    if ref.consumed != profile.totals:
        fail(f"service: in-process replay consumed {ref.consumed}")

    def arrivals():
        return PoissonArrivals(rate_hz=1.0, n_requests=10, seed=0,
                               scenario="serving_traffic", params=params)

    def want_totals(n):
        fold = ReportFold(keep_reports=False)
        for i in range(n):
            fold.add(i, ref)
        return fold.totals

    def check_requests(name, load, reps, n):
        serve = load.serve
        if load.n_arrivals != n or serve.n_ok != n or serve.n_skipped:
            fail(f"{name}: {serve.n_ok} of {load.n_arrivals} requests "
                 f"done, {serve.n_skipped} skipped")
        if sorted(reps) != list(range(n)) or any(
                r.consumed != profile.totals or r.mode != "fused"
                for r in reps.values()):
            fail(f"{name}: a request's consumed is not its profile's "
                 f"totals {profile.totals}")
        if serve.totals != want_totals(n):
            fail(f"{name}: totals {serve.totals}")
        if load.slo["n_completed"] != n or load.latency.count != n:
            fail(f"{name}: the sketch counts {load.latency.count} of {n}")

    def timing(load):
        recs = load.serve.records
        return {"wall_s": load.wall_s,
                "queue_s": quantiles(r.timing.queue_s for r in recs),
                "replay_s": quantiles(r.timing.replay_s for r in recs),
                "latency_s": {k: load.slo[k] for k in ("p50", "p99",
                                                        "p999")}}

    ck.launches = ck.iterations = mk.launches = fk.launches = 0

    # 1. a warm standing pool of 2 workers on the card, two sessions of
    # the same seeded arrivals
    timelines = []
    with StandingFleet(em, FleetConfig.process(max_workers=2,
                                               timeout=600.0)) as sf:
        spawned = time.monotonic()
        infos = sf.warmup(timeout=300.0)
        spawn_to_ready = sorted(p.last_seen - spawned
                                for p in sf.fleet._peers)
        emit("service", step="standing_warmup", ready=infos,
             spawn_to_ready_s=spawn_to_ready)
        if [i["device"] for i in infos] != [card] * 2:
            fail(f"standing pool workers run on {infos}, not on {card}")
        for session in (1, 2):
            reps = {}
            unsubscribe = sf.on_complete(
                lambda rec, rep, reps=reps: reps.update({rec.idx: rep}))
            load = run_load(em, arrivals(), standing=sf)
            unsubscribe()
            name = f"standing session {session}"
            check_requests(name, load, reps, 10)
            timelines.append([(r.meta["t"], r.meta["arrival"].params)
                              for r in load.serve.records])
            replay_spans_match(load.serve.obs["events"], name)
            emit("service", step="standing", session=session,
                 **timing(load), n_requests=load.n_arrivals,
                 worker_deaths=load.serve.recovery["worker_deaths"])
    if timelines[0] != timelines[1]:
        fail("the two sessions saw different arrival timelines")

    # 2. the same arrivals under a chaos kill: each worker dies at its
    # fourth bundle, once, and is respawned.  One worker, as in the JAX
    # package's own storm contract: every respawn is then needed to finish
    # the run, so every death is repaired inside it (with two, a respawn
    # still warming when the other worker drains the queue leaves its
    # fault open at the end, at random)
    chaos_cfg = FleetConfig.process(
        max_workers=1, chaos=ChaosPolicy(kill_every=4, max_faults=1, seed=0),
        liveness_timeout=5.0, max_respawns=6, timeout=600.0)
    with StandingFleet(em, chaos_cfg) as sf:
        sf.warmup(timeout=300.0)
        reps = {}
        sf.on_complete(lambda rec, rep: reps.update({rec.idx: rep}))
        storm = run_load(em, arrivals(), standing=sf, window_s=1.0)
        respawns = sf.fleet.respawns
    rec = storm.serve.recovery
    faulted = [w for w in storm.slo["windows"] if w["faults"]]
    emit("service", step="storm", **timing(storm),
         worker_deaths=rec["worker_deaths"], respawns=respawns,
         mttr_s=rec["mttr_s"], requeued=rec.get("requeued"),
         faulted_windows=len(faulted),
         faulted_p999_s=max((w["p999"] for w in faulted), default=None))
    check_requests("storm", storm, reps, 10)
    if rec["worker_deaths"] < 1 or respawns < 1:
        fail(f"storm: {rec['worker_deaths']} deaths, {respawns} respawns")
    if not faulted or len(storm.slo["faults"]) != rec["worker_deaths"]:
        fail(f"storm: {len(faulted)} faulted windows, "
             f"{len(storm.slo['faults'])} faults for "
             f"{rec['worker_deaths']} deaths")
    trace = replay_spans_match(storm.serve.obs["events"], "storm")
    if not any(t["name"] == "fault_opened" and t["ph"] == "i"
               for t in trace["traceEvents"]):
        fail("storm: the trace has no fault instant")

    # 3. the HTTP surface over an emulator on the card
    server = make_server(port=0, emulator=em)
    thread = __import__("threading").Thread(target=server.serve_forever,
                                            daemon=True)
    thread.start()
    try:
        host, port = server.server_address[:2]
        base = f"http://{host}:{port}"
        query = ("scenario=serving_traffic&process=constant&rate_hz=2&n=4"
                 "&workers=1&wait=1&" + "&".join(
                     f"p_{k}={v}" for k, v in params.items()))
        t0 = time.perf_counter()
        with urllib.request.urlopen(f"{base}/run?{query}",
                                    timeout=300) as r:
            run = json.loads(r.read())
        http_s = time.perf_counter() - t0
        with urllib.request.urlopen(f"{base}/metrics", timeout=60) as r:
            metrics = parse_promtext(r.read().decode())
        with urllib.request.urlopen(f"{base}{run.get('trace', '/trace')}",
                                    timeout=60) as r:
            run_trace = json.loads(r.read())
    finally:
        server.shutdown()
        thread.join(30)
        server.service.shutdown()
        server.server_close()
    report = run.get("report") or {}
    slo = report.get("slo") or {}
    counted = {f"{name}{labels}": v for fam in (
        "repro_service_runs_total", "repro_service_requests_total")
        for (name, labels), v in metrics.get(fam, {}).get(
            "samples", {}).items()}
    emit("service", step="http", state=run.get("state"),
         error=run.get("error"), seconds=http_s,
         n_completed=slo.get("n_completed"),
         latency_s={k: slo.get(k) for k in ("p50", "p99", "p999")},
         metrics=counted, trace_events=len(run_trace.get("traceEvents",
                                                          ())))
    if run.get("state") != "done" or slo.get("n_completed") != 4 or \
            report.get("n_ok") != 4:
        fail(f"http: run {run.get('state')} {run.get('error')}, "
             f"{slo.get('n_completed')} completed")
    if counted.get('repro_service_runs_total{state="done"}') != 1 or \
            counted.get('repro_service_requests_total{outcome="ok"}') != 4:
        fail(f"http: /metrics counts {counted}")
    try:
        validate_trace(run_trace)
    except ValueError as e:
        fail(f"http: the run's trace does not validate: {e}")

    # 4. a host agent on this machine, dialled by the remote executor
    agent = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.fleet.agent", "--listen",
         "127.0.0.1:0", "--workers", "2"], env=src_env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = agent.stdout.readline()
        if "listening on" not in line:
            fail(f"remote: the agent printed {line!r}")
        addr = line.strip().rsplit(" ", 1)[-1]
        t_call = obs_now()
        out = em.emulate_many(fleet_profiles,
                              config=FleetConfig.remote([addr],
                                                        timeout=600.0))
        agent_out, agent_err = agent.communicate(timeout=120)
    finally:
        if agent.poll() is None:
            agent.kill()
            agent.communicate(timeout=30)
    events = [Event.from_dict(e) for e in out.obs["events"]]
    first = min(e.t for e in events if e.kind == "dispatch")
    last = max(e.t for e in events if e.kind == "done")
    ready = [ln for ln in agent_out.splitlines() if "ready:" in ln]
    emit("service", step="remote", agent=out.cache_stats,
         join_s=first - t_call, wall_s=out.wall_s,
         replay_wall_s=last - first, serial_s=out.serial_s,
         speedup=out.speedup, ready=ready, agent_rc=agent.returncode)
    if agent.returncode != 0:
        fail(f"remote: the agent exited {agent.returncode}: "
             f"{agent_err[-2000:]}")
    if not ready or card not in ready[0]:
        fail(f"remote: the agent's workers are not on {card}: {ready}")
    if len(out.reports) != len(fleet_refs) or any(
            r.mode != "fused" or r.consumed != f.consumed
            for r, f in zip(out.reports, fleet_refs)):
        fail("remote: reports differ from the in-process replay")
    tracks = {t["args"]["name"] for t in replay_spans_match(
        events, "remote")["traceEvents"]
        if t["ph"] == "M" and t["name"] == "thread_name"}
    if not any(t.startswith("agent") for t in tracks):
        fail(f"remote: the merged trace has no agent track: {tracks}")

    # 5. the scenarios CLI on the card
    t0 = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "repro_torch.scenarios", "run",
         "serving_traffic", *[a for k, v in params.items()
                              for a in ("-p", f"{k}={v}")], "--json"],
        env=src_env(), capture_output=True, text=True, timeout=300)
    emit("service", step="cli", rc=cli.returncode,
         seconds=time.perf_counter() - t0)
    if cli.returncode != 0:
        fail(f"cli: exited {cli.returncode}: {cli.stderr[-2000:]}")
    got = json.loads(cli.stdout)["report"]
    want = profile.totals
    if (got["mode"], got["flops"], got["hbm_bytes"],
            got["storage_write_bytes"]) != (
            "fused", want.flops, want.hbm_bytes,
            want.storage_write_bytes):
        fail(f"cli: report {got}, profile totals {want}")

    launches = {"burn_tile": ck.launches, "stream_pass": mk.launches,
                "flash_attention": fk.launches}
    emit("service", step="done", launches=launches,
         seconds=time.perf_counter() - started)
    if any(launches.values()):
        fail(f"service: kernels launched in this process: {launches}")


def phase_serve(torch, np, rows):
    """Qwen2-7B at full width through the port's serving path: a depth-cut
    float32 check of the kernel against dense attention, then the full
    model in bf16 serving 4 requests under the RuntimeProfiler, its profile
    stored, reloaded and replayed by the emulator on the kernel backend,
    and a report of the kernel against dense attention at full depth."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.configs.run import SERVE_RUN, RunConfig
    from repro_torch.core import (Emulator, ProfileStore, RuntimeProfiler,
                                  calibrate)
    from repro_torch.kernels.compute_atom import kernel as ck
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.memory_atom import kernel as mk
    from repro_torch.models.model_zoo import build_model
    from repro_torch.serve.engine import Engine, Request
    dev = torch.device("cuda")
    cfg = get_config("qwen2-7b")
    V = cfg.vocab_size

    # -- depth cut: full widths, 2 layers, float32, batch 2, prompt 512 ----
    cut = dataclasses.replace(cfg, num_layers=2)
    f32 = dict(param_dtype="float32", compute_dtype="float32",
               cache_dtype="float32")
    rng = np.random.default_rng(1)
    prompts = rng.integers(0, V, (2, 512)).astype(np.int32)
    toks = torch.from_numpy(prompts).to(dev)
    params, hidden, served = None, {}, {}
    for impl in ("full", "cuda"):
        model = build_model(cut, RunConfig(attn_impl=impl, **f32))
        if params is None:
            params = model.init(torch.Generator(dev).manual_seed(0), dev)
        with torch.inference_mode():
            hidden[impl] = model.forward(params, {"tokens": toks})[0]
        reqs = Engine(model, params, batch_slots=2, max_len=520).serve(
            [Request(prompt=list(p), max_new_tokens=8) for p in prompts])
        served[impl] = [r.out_tokens for r in reqs]
    err = (hidden["cuda"] - hidden["full"]).abs().max().item()
    emit("serve", step="depth_cut_f32", layers=2, batch=2, prompt=512,
         max_abs_err_hidden=err, tol=DEPTH_CUT_TOL,
         tokens_identical=served["cuda"] == served["full"],
         tokens=served["cuda"])
    if not (torch.isfinite(hidden["cuda"]).all() and err <= DEPTH_CUT_TOL):
        fail(f"depth cut: final hidden states of 'cuda' and 'full' differ "
             f"by {err} (tolerance {DEPTH_CUT_TOL})")
    if served["cuda"] != served["full"]:
        fail(f"depth cut: greedy tokens differ: {served}")
    del params, hidden

    # -- the full model: Qwen2-7B, bf16, weights made on the card ---------
    model = build_model(cfg, dataclasses.replace(SERVE_RUN,
                                                 attn_impl="cuda"))
    t0 = time.perf_counter()
    params = model.init(torch.Generator(dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    emit("serve", step="init", seconds=time.perf_counter() - t0,
         params=model.num_params(),
         param_bytes=sum(t.numel() * t.element_size() for t in _leaves(
             params)))
    engine = Engine(model, params, batch_slots=SERVE_B,
                    max_len=max(SERVE_PROMPTS) + SERVE_NEW_TOKENS)
    rng = np.random.default_rng(2)
    prompts = [list(rng.integers(0, V, n)) for n in SERVE_PROMPTS]

    def requests(new_tokens):
        return [Request(prompt=p, max_new_tokens=new_tokens)
                for p in prompts]

    engine.serve(requests(2))             # warm up: cuBLAS picks its kernels
    times = {"prefill": [], "decode": []}

    def timed(fn, key):
        def run(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            times[key].append(time.perf_counter() - t)
            return out
        return run

    engine.prefill = timed(engine.prefill, "prefill")
    engine.decode = timed(engine.decode, "decode")
    host = calibrate(device="cpu")         # host flops per CPU second
    reqs = requests(SERVE_NEW_TOKENS)
    waves = -(-len(reqs) // SERVE_B)
    torch.cuda.reset_peak_memory_stats()
    fk.launches = 0
    prof = RuntimeProfiler(sample_rate=20).profile_callable(
        lambda: engine.serve(reqs), command="serve-qwen2-7b",
        tags={"batch": str(SERVE_B), "prompts": "2048/1536/1024/512"},
        flops_per_cpu_s=host.flops_per_s)
    launches = fk.launches
    rows["flash_attention"]["launches"] = launches
    generated = sum(len(r.out_tokens) for r in reqs)
    serve_s = sum(times["prefill"]) + sum(times["decode"])
    emit("serve", step="serve", model="qwen2-7b", layers=cfg.num_layers,
         requests=len(reqs), waves=waves,
         prefill_ms=sum(times["prefill"]) * 1e3 / waves,
         decode_ms_per_step=sum(times["decode"]) * 1e3 / len(times["decode"]),
         decode_steps=len(times["decode"]), generated_tokens=generated,
         tokens_per_s=generated / serve_s, wall_s=prof.meta["wall_s"],
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         flash_launches=launches, tokens=[r.out_tokens for r in reqs])
    if launches != cfg.num_layers * waves:
        fail(f"flash_attention launched {launches} times, want "
             f"{cfg.num_layers} layers x {waves} waves")
    for r in reqs:
        if len(r.out_tokens) != SERVE_NEW_TOKENS or not all(
                0 <= t < V for t in r.out_tokens):
            fail(f"a request got tokens {r.out_tokens}, want "
                 f"{SERVE_NEW_TOKENS} in [0, {V})")

    # where the device time of a prefill and of decode steps goes
    batch = {"tokens": torch.zeros((SERVE_B, max(SERVE_PROMPTS)),
                                   dtype=torch.int32, device=dev)}
    for i, p in enumerate(prompts):
        batch["tokens"][i, -len(p):] = torch.tensor(p, dtype=torch.int32)
    with torch.inference_mode():
        wall, busy, top = device_time(
            torch, lambda: engine.prefill(params, batch))
        emit("serve", step="trace_prefill", wall_s=wall, kernel_s=busy,
             busy_share=busy / wall, top_kernels=top)
        tok, cache = engine.prefill(params, batch)

        def decode4():
            nonlocal tok, cache
            for _ in range(4):
                tok, cache = engine.decode(params, tok, cache)

        wall, busy, top = device_time(torch, decode4)
        emit("serve", step="trace_decode_4_steps", wall_s=wall,
             kernel_s=busy, busy_share=busy / wall, top_kernels=top)
    del cache

    # -- the profile: stored, reloaded, replayed on the kernel backend -----
    with tempfile.TemporaryDirectory() as d:
        store = ProfileStore(d)
        store.add(prof)
        loaded = store.latest(prof.command, prof.tags)
    if loaded is None or loaded.totals != prof.totals:
        fail("the serve profile did not round-trip through the store")
    em = Emulator(calib=calibrate(), backend="cuda")
    table = [row for seg in em.compile(loaded).segments
             for row in seg.table.tolist()]
    ci, mi = sum(r[0] for r in table), sum(r[1] for r in table)
    legs = compute_legs(table)
    ck.launches = ck.iterations = mk.launches = 0
    rep = em.emulate(loaded)
    torch.cuda.synchronize()
    got = {"burn_tile": ck.launches, "stream_pass": mk.launches}
    emit("serve", step="replay", backend="cuda", n_samples=rep.n_samples,
         ttc_s=rep.ttc_s, profiled_wall_s=prof.meta["wall_s"],
         flops=loaded.totals.flops, compute_iters=ci, compute_legs=legs,
         burned_iters=ck.iterations, memory_iters=mi, launches=got,
         host_flops_per_cpu_s=host.flops_per_s)
    if not same_amounts(rep.consumed, loaded.totals):
        fail(f"serve replay consumed {rep.consumed} != {loaded.totals}")
    if ck.iterations != ci:
        fail(f"serve replay burned {ck.iterations} iterations, want {ci}")
    if got != {"burn_tile": legs, "stream_pass": mi}:
        fail(f"serve replay launched {got}, want {legs} burns (one a "
             f"compute leg), {mi} streams")

    # -- report: full depth, bf16, the kernel against dense attention ------
    full = build_model(cfg, dataclasses.replace(SERVE_RUN,
                                                attn_impl="full"))
    last = {}
    with torch.inference_mode():
        for name, m in (("cuda", model), ("full", full)):
            h = m.forward(params, batch)[0][:, -64:]
            last[name] = m.logits(params, h).float()
            if not torch.isfinite(last[name]).all():
                fail(f"full depth {name}: logits are not finite")
    agree = (last["cuda"].argmax(-1) == last["full"].argmax(-1)).float()
    emit("serve", step="full_depth_bf16_report", positions=64,
         token_agreement=agree.mean().item(),
         max_abs_logit_diff=(last["cuda"] - last["full"]).abs().max().item(),
         max_abs_logit=last["full"].abs().max().item())


def compute_legs(table) -> int:
    """Rows of a compiled table that burn: the kernel backend launches one
    burn for each."""
    return sum(r[0] > 0 for r in table)


def same_amounts(a, b, rel: float = 1e-12) -> bool:
    """Field-for-field equality of two ResourceVectors up to float64
    rounding: ``consumed`` sums collapsed runs (count x amount), a
    profile's totals sum its samples one by one, and a runtime profile's
    amounts are not round numbers, so the two sums may differ in the last
    bits (the JAX package's own test allows 1e-6, tests/test_system.py)."""
    fa, fb = a.to_dict(), b.to_dict()
    if fa.keys() != fb.keys():
        return False
    for k in fa:
        x, y = fa[k], fb[k]
        if isinstance(x, dict):
            if x.keys() != y.keys() or not all(
                    math.isclose(x[i], y[i], rel_tol=rel) for i in x):
                return False
        elif not math.isclose(x, y, rel_tol=rel):
            return False
    return True


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


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
    calib, per_iter_ms = phase_main_path(torch, rows)
    fleet_profiles, fleet_refs = phase_fleet(torch, calib, per_iter_ms)
    phase_service(torch, calib, fleet_profiles, fleet_refs)
    phase_serve(torch, np, rows)
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

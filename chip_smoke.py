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
             the memory atom's chained passes (against L2) and its ring
             (against HBM; the pass rate at 1, 2, R and 2R slots); the
             segment kernel at tiles 64, 128 and 256 over tables with zero,
             compute-only and memory-only rows, then at the main path's
             table; flash attention over the JAX package's test sweep,
             Gemma2's head dim and the serving shape
  main_path  the emulator end to end: a Qwen2-7B-sized ``serving_traffic``
             profile is stored, reloaded, and emulated with the fused
             ``"torch"`` backend, the per-sample ``"cuda"`` backend (a burn
             and a ring launch a leg) and the fused ``"cuda"`` backend (one
             segment kernel launch a segment, its device-counted
             iterations and passes the table's); dispatches, iterations
             and kernel launches are checked against the schedule, the
             device's busy share is read from the launches and the device
             time of each, and ``predict`` is printed beside; the
             ``"torch"`` backend's memory leg (in-place passes over the
             atom's ring) fails above 1.05 x the HBM rate, as the ring
             kernel does
  collective the collective atom on a mesh whose shards all live on the
             card (printed as ``shared``): ``csrc/collective.cu`` (the
             per-sample collective) and the segment kernel's wire leg
             against their plain versions for each kind on a 2-shard
             mesh and ``collective.cu`` at five shape cases (16-byte
             vectors, a ragged inner, 3 shards, an outer axis, an
             all-gather block no multiple of 4), a 1-shard all-reduce
             folded to nothing, the segment kernel's registers (fails on a
             spill), the round trip of one wire step through L2, the peer
             CTA's shared memory and the CTA's own (``csrc/l2_probe.cu``),
             the wire leg's device time a step at 2 and 4 shards beside
             the L2 bound, a library call and NVLink's time for the same
             wire bytes; then a
             Qwen2-7B ``training_scan`` with a 2-way data-parallel step's
             wire bytes replayed fused (one segment launch, the device's
             counts of all three legs the table's, consumed equal to
             planned, emulated wire bytes the quantized table's) and per
             sample (one collective launch a wire leg, at a tenth of the
             wire bytes, printed as ``reduced``), each beside
             ``predict``; and a 2-worker process fleet whose workers
             build their own mesh on the card and replay the mesh-bound
             bundle as this process does; last, ``collective.cu`` at the
             operand the per-sample run gave it (6.08 GB), against its
             plain version, timed beside the HBM bound and a library call
  fleet      fleet emulation through ``run_fleet`` / ``emulate_many``:
             Qwen2-7B serving and training profiles (published widths,
             cut in tokens, steps and checkpoint bytes) with the other
             scenario families, on 2 threads of the ``"cuda"`` backend
             (consumed equals planned, iterations, passes and kernel
             launches equal the schedule's), on warm pools of 1 and 2
             spawned worker processes replaying ``"cuda"`` segments on the
             card (reports equal the in-process replay; spawn-to-ready per
             worker; a worker whose device counters fall short of its
             table raises), as a fork-join DAG
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
             every trace validates with one replay span a dispatch; the
             pools, HTTP and the agent replay on the ``"cuda"`` backend
             (the CLI, like the JAX package's, on its default)
  serve      the dense zoo's serving path: Qwen2-7B's widths cut to 2
             layers in float32, the flash kernel against dense attention
             (final hidden states, greedy tokens); then the full model in
             bf16 (weights made on the card from a seed) serving 4
             requests under the ``RuntimeProfiler`` (prefill and decode
             times, tokens/s, peak memory, flash launches = layers x
             waves), traced prefill and decode steps, the profile stored,
             reloaded and replayed on the ``"cuda"`` emulator backend, and
             a full-depth report of the kernel against dense attention
  static     the static watcher (``profile_step``, the operator counter)
             at Qwen2-7B's widths: the serve phase's full-depth bf16
             prefill on the card (28 flash launches; glue, 28 layer
             samples, glue; dot flops within 1e-9 of the analytic count),
             the same step on meta tensors (the same cost bit for bit, no
             launch), the train phase's 4-layer step on the card (forward
             and backward layer samples), each profile replayed fused on
             the ``"cuda"`` emulator (one segment launch, device counts the
             plan's, consumed flops within 1e-6 of the profile's), with
             the emulated time, ``predict`` on the H100, the measured step
             and the profiling overhead printed beside
  train      the training path: blocked attention (flash and banded)
             against dense attention at Qwen2-7B's heads, forward and
             dq/dk/dv in float32 and the forward in bf16, each timed
             beside ``scaled_dot_product_attention``; the tiny config's
             train step on the card against the CPU; Qwen2-7B's widths cut
             to 4 layers trained through ``make_job``/``train`` on 1 x 4096
             tokens (bf16 compute, f32 master weights, remat, chunked
             loss) with a checkpoint after step 2, a failure injected
             there and a restore (step times, tokens/s, peak memory,
             the share of the bf16 peak, checkpoint seconds, a traced
             step's busy share); the profile of two steps replayed on the
             ``"cuda"`` backend in one segment launch
  families   the other model families at their published widths:
             Llama-4-Scout (MoE, cut to 8 layers), Moonlight-16B-A3B
             (MoE), Qwen2-VL-2B (vision embeds with M-RoPE), Mamba-2-780M,
             Hymba-1.5B (prompts past its 2048-token window) and
             SeamlessM4T-medium (encoder-decoder).  Each: a float32 depth
             cut, the flash kernel against dense attention (final hidden
             states within 1e-4, identical greedy tokens); then bf16
             weights made on the card from a seed, its traffic under the
             ``RuntimeProfiler`` (prefill and decode times, tokens/s, peak
             memory, the MoE drop fraction, flash launches = attention
             layers that route to it x waves), a trace of a prefill and
             decode steps that holds every flash launch (busy share), and
             the profile replayed fused on the ``"cuda"`` emulator backend
             with the table's device counts.  Mamba-2's SSD scan against
             its recurrent oracle at its heads and prefill then decode
             against one forward; one MoE training step
  dryrun     the dry-run (``repro_torch.launch.dryrun``): Qwen2-7B's
             train_4k, prefill_32k, decode_32k and long_500k (a skip
             record) and Qwen2-1.5B's decode_32k on the 16 x 16 mesh,
             Qwen2-72B's decode_32k on 2 x 16 x 16, each on DTensors with
             meta shards over a fake process group of 256 or 512 ranks:
             memory, walker and seconds, and ``predict`` on the H100 of the
             artifact; then two cells that fit one card, run on a 1 x 1
             mesh on meta and for real on the card with bf16 weights from
             seed 0 (Qwen2-7B's prefill of 4 x 2048 tokens at full depth,
             the train phase's 4-layer step of 1 x 4096 tokens): argument
             bytes exact, the card's counted flops within 1e-9, its peak of
             allocated memory within 15% of ``per_device_total``
  examples   every ``examples/torch_*.py`` on the card as a subprocess:
             exit 0, wall time

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
# a ring pass may not read faster than this share of the HBM datasheet
# rate: faster, it would be reading L2
RING_MAX_OF_HBM = 1.05
# segment tables checked against the plain version: zero rows (and pow2
# padding), compute-only rows, memory-only rows, both legs in one row
SEGMENT_TABLES = [
    [[3, 2, 0], [0, 1, 0], [5, 0, 0], [0, 0, 0]],
    [[0, 0, 0], [7, 0, 0]],
    [[0, 4, 0]],
    [[2, 3, 0]] * 5,
    [[17, 0, 0], [0, 0, 0], [0, 9, 0], [1, 1, 0]],
]
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
# Qwen2-7B trained 2-way data parallel: the ring all-reduce of its bf16
# gradients moves 2 x (2 - 1) / 2 x 2 bytes x 7.6e9 parameters a step
QWEN2_7B_TRAIN_WIRE = 2 * (2 - 1) / 2 * 2 * QWEN2_7B_PARAMS
# the collective phase's cuts: tokens and steps as the fleet phase's, no
# checkpoint (a storage leg would replay the wire leg per sample at full
# size), and on the per-sample path a tenth of the wire bytes: its operand
# is n x the shard's bytes on one card (30 GB a step at full size, and as
# much again for the all-reduce's output)
COLLECTIVE_CUTS = {"tokens_per_step": 16, "n_steps": 2, "ckpt_every": 0,
                   "per_sample_ici_per_step": QWEN2_7B_TRAIN_WIRE / 10}
# NVLink, each way (NVIDIA's H100 datasheet): what the wire bytes would
# take between two cards, printed beside the one card's emulated time
NVLINK_BPS = 450e9
COLL_TOL = 1e-6            # float32 collectives: rtol and atol
# collective.cu's shape cases, (shards shape, dim): 16-byte vectors with
# several a thread, a ragged inner (one float a column), 3 shards, an
# outer axis with a middle one, and an all-gather block not a multiple of 4
COLL_CASES = [((2, 1 << 20), 0), ((4, 333), 0), ((3, 4096), 0),
              ((2, 3, 2, 512), 1), ((2, 2, 3, 6), 2)]
# the wire leg's carries timed a step: the 2-shard mesh's and a 4-shard one
WIRE_SHARDS = (2, 4)
# the serving shape: Qwen2-7B's prefill of 4 prompts of 2048 tokens
SERVE_B, SERVE_S, SERVE_HQ, SERVE_HK, SERVE_HD = 4, 2048, 28, 4, 128
SERVE_PROMPTS = (2048, 1536, 1024, 512)
SERVE_NEW_TOKENS = 16
# blocked attention against dense attention at Qwen2-7B's heads (28 query,
# 4 KV heads, head dim 128), batch 1: the JAX package's own tolerances
# (tests/test_model_correctness.py): 2e-5 forward and 3e-5 gradients in
# float32, 2e-2 in bfloat16; the banded case is a 512-token window with
# block_q 512 and block_kv 1024 (a band of 1024 keys)
TRAIN_ATTN_SEQS = (2048, 4096)
ATTN_BLOCKS = (512, 1024)          # block_q, block_kv: RunConfig's defaults
ATTN_FWD_TOL, ATTN_GRAD_TOL, ATTN_BF16_TOL = 2e-5, 3e-5, 2e-2
BANDED_WINDOW = 512
# the tiny config of tests/test_train_loop.py, one step on the card against
# the same step on the CPU (float32, TF32 off), from init seeds 0-3 and
# batches 0 and 5: loss and gradient norm within 1e-4; the AdamW moments
# within 5e-4 of each leaf's largest (the config's float32 floor: its
# stacked weights' std of 0.71 saturates the attention, and the two
# packages' moments differ by up to 3.8e-4 of a leaf's largest on the CPU,
# tests/test_torch_train.py); the card's parameters within 1e-6 of AdamW
# applied on the host to the card's own moments.  Parameters are not held
# to the CPU's directly: AdamW's first step, lr g / (|g| + eps), turns a
# float32 gradient difference near g = 0 into up to lr of a parameter
# (2.4e-4 seen on the card).  The same steps with TF32 matmuls on the card
# are the planted fault: the bounds must reject every one of them
TINY_STEP_TOL, TINY_MOMENT_TOL, TINY_UPDATE_TOL = 1e-4, 5e-4, 1e-6
TINY_SEEDS, TINY_BATCHES = (0, 1, 2, 3), (0, 5)
# training at Qwen2-7B's published widths cut to 4 layers (2.02e9
# parameters, 24.2 GB of float32 weights and moments), batch 1 x 4096
# tokens so that "auto" attention takes the blocked path; 3 steps with a
# checkpoint after step 2, one kept, and a failure injected before step 2,
# so the run restores from step 2.  One checkpoint, not one a step: a
# checkpoint commits before the last one is collected, so a second save
# would put two (45.2 GiB) on the disk at once
TRAIN_LAYERS, TRAIN_SEQ, TRAIN_STEPS, TRAIN_FAIL_AT = 4, 4096, 3, 2
TRAIN_CKPT_EVERY = 2
# the other families at their published widths: (config, layers on the
# card or None for all, traffic).  Llama-4-Scout's 48 layers need ~216 GB
# of bf16 weights: 8 layers (~39.4 GB) fit the card.  "engine": Engine.serve
# of the serve phase's four prompts; "engine_long": four prompts above
# Hymba's 2048-token window; "vision": embeds with M-RoPE positions through
# the prefill and decode steps; "encdec": audio frames and target tokens
FAMILY_RUNS = (
    ("llama4-scout-17b-a16e", 8, "engine"),
    ("moonshot-v1-16b-a3b", None, "engine"),
    ("qwen2-vl-2b", None, "vision"),
    ("mamba2-780m", None, "engine"),
    ("hymba-1.5b", None, "engine_long"),
    ("seamless-m4t-medium", None, "encdec"),
)
LONG_PROMPTS = (4096, 3072, 2048, 1024)
VISION_GRID = (1, 32, 32)      # 1024 vision positions of 2048, text after
ENCDEC_SRC, ENCDEC_TGT = 1024, 512
FAMILY_DECODE_STEPS = 16       # "vision" and "encdec": after the prefill
# the float32 depth cuts: 2 layers (Hymba 4, so that layer 1 is a local,
# windowed one), batch 2; prompts of 512 tokens, Hymba's of 3072 so that
# its window bites, the encoder-decoder 512 frames and 256 target tokens;
# 8 greedy decode steps after the prefill.  Final hidden states within
# DEPTH_CUT_TOL of the larger of 1 and their largest magnitude: at full
# width the cut's weights (std 1/sqrt(2), the stacked leaves' fan-in)
# saturate attention: Moonlight's cut differs by 2.29e-4 where |h|
# reaches 5.1 on an H100, that float32 floor, as in
# tests/test_torch_families.py.  The encoder-decoder is held at flash's
# two uses apart (encdec_cut_parts)
CUT_LAYERS = {"hybrid": 4}
CUT_B, CUT_S, CUT_LONG_S, CUT_DECODE_STEPS = 2, 512, 3072, 8
# Mamba-2-780M's SSD scan on the card against its recurrent oracle: its
# heads (H 48, P 64, N 128, G 1), S 2048, chunk 256, batch 1, within the
# JAX package's 1e-4 of the oracle's largest magnitude (elementwise, the
# output's entries span 1e-3..3e2 at these widths and the chunked form
# sums them in another order: 1.9e-3 where |y| ~ 4 on the CPU); prefill
# then decode against one forward of the float32 cut within 2e-3 (atol
# and rtol: tests/test_model_correctness.py)
SSD_HEADS, SSD_SEQ, SSD_TOL, MAMBA_DECODE_TOL = 48, 2048, 1e-4, 2e-3
MAMBA_PREFIX, MAMBA_DECODE = 32, 16
# one MoE training step: Moonlight-16B-A3B's widths cut to 2 layers (1.81e9
# parameters, ~29 GB of f32 weights and moments), batch 1 x 4096 tokens
MOE_TRAIN_LAYERS, MOE_TRAIN_SEQ = 2, 4096
# the static watcher: the prefill's dot flops within STATIC_DOT_TOL of the
# analytic count (integers below 2^53 summed in float64: exact but for
# the order of the sum); a replay's consumed flops within
# STATIC_REPLAY_TOL of the profile's (each compute row rounds to whole
# 2 x 256^3-flop burn iterations); steps timed STATIC_TIMED_STEPS times
STATIC_DOT_TOL, STATIC_REPLAY_TOL, STATIC_TIMED_STEPS = 1e-9, 1e-6, 3
# the examples phase: every examples/torch_*.py, each within its timeout
EXAMPLES_WANTED, EXAMPLE_TIMEOUT_S = 9, 600
# the dry-run (src/repro_torch/launch/dryrun.py): production cells on the
# 16 x 16 mesh (256 fake ranks) and Qwen2-72B's decode on 2 x 16 x 16
# (512), each (arch, shape, multi-pod); a decode cell's per-device bytes
# must fit the 80 GB of an H100
DRYRUN_CELLS = (("qwen2-7b", "train_4k", False),
                ("qwen2-7b", "prefill_32k", False),
                ("qwen2-7b", "decode_32k", False),
                ("qwen2-7b", "long_500k", False),
                ("qwen2-1.5b", "decode_32k", False),
                ("qwen2-72b", "decode_32k", True))
DRYRUN_DEVICE_BYTES = 80e9
# the dry-run on a 1 x 1 mesh against the same step on the card: argument
# bytes exact, flops within DRYRUN_FLOPS_TOL (integers summed in float64
# in other orders), the card's peak of allocated memory within
# DRYRUN_MEMORY_TOL of per_device_total (the caching allocator rounds
# each block up, which the counter cannot see: the card's peaks came to
# 1.00005-1.0017 of the prediction, PERF.md §6, so 1% still fails a
# prediction that leaves out one loss chunk's logits); the whole phase
# within DRYRUN_PHASE_S
DRYRUN_FLOPS_TOL, DRYRUN_MEMORY_TOL, DRYRUN_PHASE_S = 1e-9, 0.01, 150.0


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


def wire_round_trips(torch, grid: int, steps: int = 20000) -> dict:
    """The wire leg's latency floor: ``csrc/l2_probe.cu``'s chain of
    all-reduce steps on a 2-shard carry, one thread a column, each step
    reading what the last wrote, with the column in device memory (L2),
    in the peer CTA's shared memory (the segment's medium) and, for what
    of a step is not the trip, in the CTA's own, on one cluster of 2 CTAs
    and on ``grid`` CTAs (the segment's).  Cycles (thread 0's SM clock) and
    microseconds (CUDA events around the launch) a step."""
    from repro_torch.kernels import build
    lib = build.load()
    cycles = torch.zeros(1, dtype=torch.int64, device="cuda")
    out = {}
    for medium, name in ((0, "l2"), (1, "peer_smem"), (2, "own_smem")):
        for ctas in (2, grid):
            carry = torch.ones((2, ctas * 256), device="cuda")

            def probe():
                build.check(lib, lib.synapse_wire_probe(
                    carry.data_ptr(), 2, ctas, 0, steps, medium,
                    cycles.data_ptr(), torch.cuda.current_device(),
                    torch.cuda.current_stream().cuda_stream), "wire_probe")

            us = event_ms(probe, 3) * 1e3 / steps
            if not torch.equal(carry, torch.ones_like(carry)):
                fail(f"wire probe ({name}, {ctas} CTAs): the all-reduce of "
                     "ones did not stay ones")
            out[f"{name}_{ctas}ctas"] = {
                "cycles": cycles.item() / steps, "us": us}
    return out


def ptxas_numbers(lines) -> dict:
    """Registers and spill bytes from a kernel's ptxas lines."""
    text = " ".join(lines)
    regs = re.search(r"Used (\d+) registers", text)
    spills = [int(v) for v in re.findall(r"(\d+) bytes spill", text)]
    return {"registers": int(regs.group(1)) if regs else None,
            "spill_bytes": sum(spills)}


def device_time(torch, fn):
    """Run ``fn`` under ``torch.profiler``: (wall seconds, seconds of CUDA
    kernels, every kernel as [name, s, count], the most time first)."""
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
    return wall, sum(k[1] for k in kernels), [list(k) for k in kernels]


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
    return kernels


def phase_kernels(torch, np, build_info):
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
    main = rates[1 << 22]
    chained = {k: main[k] for k in ("ms", "plain_ms", "library_ms",
                                    "bound_ms", "bound_by", "bound_rate")}
    chained.update(max_abs_err=stream_err,
                   unit="one pass (one launch) over a 16 MiB float32 block, "
                        "chained: the JAX package's stream, in L2",
                   timing="device time: CUDA graph of 200 passes")
    rows["stream_pass"] = phase_ring(torch, np, rng, chained)
    rows["segment"] = phase_segment(torch, np, rng, build_info,
                                    rows["stream_pass"]["ring_slots"])
    rows["flash_attention"] = phase_flash(torch, np, rng)
    return rows


def phase_ring(torch, np, rng, chained):
    """The memory atom's ring entry: bit for bit against its plain version
    at the atom's 16 MiB block over R slots, then its pass rate at 1, 2, R
    and 2R slots beside the HBM bound; fails if a pass at R slots reads
    faster than RING_MAX_OF_HBM x the HBM rate (it would be reading L2)."""
    from repro_torch.kernels.memory_atom import kernel as mk, ref as mref
    dev = torch.device("cuda")
    block = 1 << 24
    R = mk.ring_slots(block, dev)
    l2 = mk.l2_cache_bytes(dev)
    ring = mk.Ring(block, dev)
    ring.data.copy_(torch.from_numpy(rng.standard_normal(
        (R, block // 4)).astype(np.float32)))
    want = ring.data.clone()
    passes = 2 * R + 3
    mk.stream_ring(ring, passes=passes)
    mref.ring_pass(want, start=0, passes=passes)
    torch.cuda.synchronize()
    err = (ring.data - want).abs().max().item()
    bitwise = torch.equal(ring.data, want)
    emit("kernels", kernel="stream_ring", slots=R, passes=passes,
         max_abs_err=err, bitwise=bitwise, l2_bytes=l2,
         ring_bytes=R * block)
    if not bitwise or R * block < 4 * l2:
        fail(f"stream_ring: {R} slots of {block} bytes against an L2 of "
             f"{l2}; max abs err {err}")
    del want
    reps = 200
    per_pass = {}
    for slots in (1, 2, R, 2 * R):
        r_ = ring if slots == R else mk.Ring(block, dev, slots=slots)
        per_pass[slots] = event_ms(
            lambda r_=r_: mk.stream_ring(r_, passes=reps), 3) / reps
        emit("kernels", kernel="stream_ring", slots=slots,
             us_per_pass=per_pass[slots] * 1e3,
             TB_per_s=2 * block / (per_pass[slots] * 1e-3) / 1e12)
        del r_
    keep = abs(per_pass[2 * R] - per_pass[R]) <= 0.05 * per_pass[R]
    emit("kernels", kernel="stream_ring", step="ring_size", R=R,
         two_R_within_5_percent_of_R=keep,
         note="R kept" if keep else "2R streams more than 5% apart from R")
    scale = 1.0000001
    ms = per_pass[R]
    t_bytes, t_ops = 2 * block / PEAK_HBM_BPS, (block // 4) / PEAK_FP32_FLOPS
    row = {
        "name": "stream_pass", "route": "cuda",
        "source": "src/repro_torch/csrc/memory_atom.cu",
        "device_code": "src/repro_torch/csrc/ring.cuh",
        "replaces": "src/repro/kernels/memory_atom/kernel.py:23",
        "max_abs_err": err, "ms": ms,
        "plain_ms": graph_ms(lambda: mref.ring_pass(
            ring.data, start=0, passes=2 * R), 2 * R),
        "library_ms": graph_ms(lambda: [torch.mul(
            ring.data[p % R], scale, out=ring.data[p % R])
            for p in range(2 * R)], 2 * R),
        "library": "torch.mul in place (out=) on each slot",
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bound_rate": "HBM, datasheet",
        "ring_slots": R, "ring_us_per_pass": {
            str(k): v * 1e3 for k, v in per_pass.items()},
        "unit": "one in-place pass over a 16 MiB float32 block of a ring of "
                f"{R} (the memory atom's entry)",
        "timing": "device time: CUDA events around one launch of 200 "
                  "passes; plain and library: CUDA graph of 2R passes",
        "chain": chained,
    }
    row["share_of_bound"] = row["bound_ms"] / ms
    emit("kernels", kernel="stream_ring", **{
        k_: v_ for k_, v_ in row.items() if k_ not in ("name", "chain")})
    if ms < row["bound_ms"] / RING_MAX_OF_HBM:
        fail(f"stream_ring: {ms * 1e3} us a pass, above {RING_MAX_OF_HBM}"
             f" x the HBM rate: the ring is not reading device memory")
    return row


def main_path_profile():
    """The emulation main path's profile: Qwen2-7B-sized serving traffic."""
    from repro_torch.scenarios import generate
    return generate("serving_traffic", n_requests=2, prefill_tokens=128,
                    decode_tokens=16, seed=0, **QWEN2_7B_SERVING)


def phase_segment(torch, np, rng, build_info, ring_slots):
    """The segment kernel against its plain version at tiles 64, 128 and
    256 over SEGMENT_TABLES (device counters exact), then at the main
    path's table (tile 256, the atom's 16 MiB block in a ring of R): its
    result against the plain version's, its device time and the plain
    version's (one host-issued walk of the table)."""
    from repro_torch.core import Emulator, HostCalibration
    from repro_torch.core.atoms import compute_operand
    from repro_torch.kernels.compute_atom import ref as cref
    from repro_torch.kernels.memory_atom import kernel as mk, ref as mref
    from repro_torch.kernels.segment import kernel as sk, ref as sref
    dev = torch.device("cuda")
    seg_err = 0.0
    for tile in sk.TILES:
        for table in SEGMENT_TABLES:
            t = np.asarray(table, np.int32)
            ci, mi = int(t[:, 0].sum()), int(t[:, 1].sum())
            x = torch.from_numpy((rng.standard_normal((tile, tile)) * 0.1)
                                 .astype(np.float32)).to(dev)
            ring = mk.Ring(1 << 18, dev, slots=3)
            ring.data.copy_(torch.from_numpy(rng.standard_normal(
                (3, 1 << 16)).astype(np.float32)))
            ring.passes = 5
            want_ring = ring.data.clone()
            want_y = sref.run_segment(t, x, want_ring, start=5)
            before = (sk.launches, sk.iterations, sk.passes)
            run = sk.run_segment(t, x if ci else None, ring if mi else None)
            torch.cuda.synchronize()
            run.settle()
            counted = (sk.launches - before[0], sk.iterations - before[1],
                       sk.passes - before[2])
            err = (run.y - want_y).abs().max().item() if ci else 0.0
            ok = (not ci or (bool(torch.isfinite(run.y).all())
                             and torch.allclose(run.y, want_y, atol=BURN_TOL,
                                                rtol=BURN_TOL))) \
                and torch.equal(ring.data, want_ring) \
                and counted == (1, ci, mi)
            emit("kernels", kernel="segment", tile=tile, table=table,
                 max_abs_err=err, counted=counted, ok=ok)
            if not ok:
                fail(f"segment tile={tile} table={table}: max abs err {err}"
                     f", counted (launches, iterations, passes) {counted}")
            seg_err = max(seg_err, err)

    # the main path's table: the profile compiled for the "cuda" backend
    block, tile = 1 << 24, 256
    em = Emulator(calib=HostCalibration(1.0, 1.0, 1.0, 1.0), backend="cuda")
    tables = [s.table for s in em.compile(main_path_profile()).segments]
    ci = sum(int(t[:, 0].sum()) for t in tables)
    mi = sum(int(t[:, 1].sum()) for t in tables)
    x = compute_operand(tile, dev)
    ring = mk.Ring(block, dev)
    want_ring = ring.data.clone()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    want_y, p = None, 0
    for t in tables:
        want_y = sref.run_segment(t, x, want_ring, start=p)
        p += int(t[:, 1].sum())
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    runs = [sk.run_segment(t, x, ring) for t in tables]
    torch.cuda.synchronize()
    for run in runs:
        run.settle()
    err = (runs[-1].y - want_y).abs().max().item()
    if not (torch.allclose(runs[-1].y, want_y, atol=BURN_TOL, rtol=BURN_TOL)
            and torch.equal(ring.data, want_ring)):
        fail(f"segment at the main path's table: max abs err {err}, or the "
             "ring differs from the plain version's")
    del want_ring
    times = []
    for _ in range(2):
        start.record()
        runs = [sk.run_segment(t, x, ring) for t in tables]
        end.record()
        end.synchronize()
        for run in runs:
            run.settle()
        times.append(start.elapsed_time(end))
    ms = min(times)
    # each leg alone, in one launch at the main path's totals
    legs = {}
    for leg, t in (("compute", [[ci, 0, 0]]), ("memory", [[0, mi, 0]])):
        t = np.asarray(t, np.int32)
        start.record()
        run = sk.run_segment(t, x if leg == "compute" else None,
                             ring if leg == "memory" else None)
        end.record()
        end.synchronize()
        run.settle()
        legs[leg] = start.elapsed_time(end)
    emit("kernels", kernel="segment", step="segment_legs", compute_ms=legs[
        "compute"], us_per_iteration=legs["compute"] * 1e3 / ci,
         memory_ms=legs["memory"], us_per_pass=legs["memory"] * 1e3 / mi,
         legs_sum_ms=legs["compute"] + legs["memory"], segment_ms=ms)
    flops = cref.flops(tile, ci)
    nbytes = mref.bytes_moved(block, mi) + 3 * tile * tile * 4
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BPS
    resources = {k: v["ptxas"] for k, v in build_info.items()
                 if "segment_kernel" in k}
    row = {
        "name": "segment", "route": "cuda",
        "source": "src/repro_torch/csrc/segment.cu",
        "device_code": ["src/repro_torch/csrc/burn.cuh",
                        "src/repro_torch/csrc/ring.cuh"],
        "replaces": "src/repro/core/schedule.py:336 (SegmentRunner._fn, a "
                    "jitted lax.scan; not a Pallas kernel)",
        "max_abs_err": max(seg_err, err), "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "bound_rate": "float32 FMA and HBM, datasheet",
        "bound_legs_in_sequence_ms": (t_ops + t_bytes) * 1e3,
        "library_ms": None,
        "library": "none: no one PyTorch call walks an iteration table",
        "table": [t.tolist() for t in tables], "compute_iters": ci,
        "memory_iters": mi, "ring_slots": ring_slots,
        "grid": sk.grid_info(tile, dev), "ptxas": resources,
        "unit": f"the main path's {len(tables)} segment(s) at tile 256 and "
                "a 16 MiB block, one launch each",
        "timing": "device time: CUDA events around the launches, the best "
                  "of 2; plain: CUDA events around one host-issued walk",
    }
    row["share_of_bound"] = row["bound_ms"] / ms
    emit("kernels", kernel="segment", **{
        k_: v_ for k_, v_ in row.items() if k_ != "name"})
    return row


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


def counters() -> dict:
    """Every kernel counter of the emulation path."""
    from repro_torch.kernels.collective import kernel as wk
    from repro_torch.kernels.compute_atom import kernel as ck
    from repro_torch.kernels.memory_atom import kernel as mk
    from repro_torch.kernels.segment import kernel as sk
    return {"burn_tile": ck.launches, "burn_iters": ck.iterations,
            "stream_ring": mk.ring_launches, "ring_passes": mk.ring_passes,
            "stream_chain": mk.launches, "segment": sk.launches,
            "segment_iters": sk.iterations, "segment_passes": sk.passes,
            "segment_wire": sk.wire_launches, "segment_steps": sk.steps,
            "collective": wk.launches}


def zero_counters() -> None:
    from repro_torch.kernels.collective import kernel as wk
    from repro_torch.kernels.compute_atom import kernel as ck
    from repro_torch.kernels.memory_atom import kernel as mk
    from repro_torch.kernels.segment import kernel as sk
    ck.launches = ck.iterations = 0
    mk.launches = mk.ring_launches = mk.ring_passes = 0
    sk.launches = sk.iterations = sk.passes = 0
    sk.wire_launches = sk.steps = 0
    wk.launches = 0


def planned_counts(em, profile, fused: bool = True) -> dict:
    """The ``counters()`` that ``em.emulate(profile, fused=fused)`` must
    leave on the ``"cuda"`` backend: one segment launch a non-noop segment
    (its iterations and passes device-counted), and on the per-sample path
    (barrier steps, or every run when not fused) one burn launch a compute
    leg, one ring launch a memory leg and, on an emulator with a mesh, one
    collective launch a wire leg; a segment with wire rows counts its
    collective steps on the device too."""
    from repro_torch.core.emulator import _collapse
    from repro_torch.core.schedule import FusedSegment
    want = dict.fromkeys(counters(), 0)
    if em.compute.backend != "cuda":
        return want

    def per_sample(r, reps):
        c, m = em.compute.iters_for(r.flops), em.memory.iters_for(
            r.hbm_bytes)
        want["burn_tile"] += (c > 0) * reps
        want["burn_iters"] += c * reps
        want["stream_ring"] += (m > 0) * reps
        want["ring_passes"] += m * reps
        if em.collective is not None and r.ici_total > 0:
            want["collective"] += (em.collective.quant().factor > 0) * reps

    if fused and em._fusable:
        for step in em.compile(profile).steps:
            if isinstance(step, FusedSegment):
                if step.compute_iters or step.memory_iters \
                        or step.collective_iters:
                    want["segment"] += 1
                    want["segment_iters"] += step.compute_iters
                    want["segment_passes"] += step.memory_iters
                    want["segment_wire"] += step.collective_iters > 0
                    want["segment_steps"] += step.collective_iters
            else:               # a storage leg: replayed sample by sample
                per_sample(step.resources, step.count)
        return want
    for r, count in _collapse(profile.samples):
        storage = r.storage_read_bytes > 0 or r.storage_write_bytes > 0
        if count > 1 and not storage:
            per_sample(r.scale(count), 1)
        else:
            per_sample(r, count)
    return want


#: the main path's runs: (backend, fused)
MAIN_PATH_RUNS = (("torch", True), ("cuda", False), ("cuda", True))
#: traces of a cut run taken before one that holds every counted launch
TRACE_ATTEMPTS = 3
#: counter -> the symbol of its kernel in a trace
TRACED_KERNELS = (("segment", "segment_kernel"),
                  ("burn_tile", "burn_cluster"),
                  ("stream_ring", "::stream_ring("))


def torch_ring_pass_ms(torch, block: int = 1 << 24):
    """The ``"torch"`` backend's memory leg on the card: device ms of one
    in-place pass over the memory atom's ring of ``block``-byte slots (a
    CUDA graph of two rounds of the ring), its bytes a second (a read and
    a write of the block) and the ring's slots."""
    from repro_torch.core.atoms import memory_operand, memory_stream_body
    ring = memory_operand(block, "cuda")
    passes = 2 * ring.slots
    ms = graph_ms(lambda: [memory_stream_body(ring, p)
                           for p in range(passes)], passes)
    return ms, 2 * block / (ms * 1e-3), ring.slots


def phase_main_path(torch, rows):
    """The emulator end to end on a Qwen2-7B-sized profile; returns the
    calibration and the device milliseconds of one iteration of each
    backend's compute and memory legs, which the fleet phase reuses."""
    from repro_torch.core import (H100_SXM, Emulator, ProfileStore,
                                  SegmentRunner, calibrate, get_spec,
                                  predict)
    from repro_torch.core.atoms import compute_burn_body, compute_operand
    from repro_torch.core.schedule import FusedSegment
    from repro_torch.scenarios import generate

    profile = main_path_profile()
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
    # (tile 256, 16 MiB block): the kernels' from the kernels phase (the
    # burn, and a pass over the ring), the segment loop's torch ops' from a
    # captured chain of iterations and of passes over the "torch" ring,
    # which fails above RING_MAX_OF_HBM x the HBM rate (L2's, not HBM's)
    xc = compute_operand(256, "cuda")
    ring_ms, ring_bps, ring_slots = torch_ring_pass_ms(torch)
    per_iter_ms = {
        "cuda": (rows["burn_tile"]["ms"], rows["stream_pass"]["ms"]),
        "torch": (graph_ms(lambda: chain(compute_burn_body, xc, 100), 100),
                  ring_ms),
    }
    emit("main_path", step="iteration_device_ms", **per_iter_ms)
    emit("main_path", step="torch_memory_leg", ring_slots=ring_slots,
         us_per_pass=ring_ms * 1e3, bytes_per_s=ring_bps,
         share_of_hbm=ring_bps / PEAK_HBM_BPS, max_of_hbm=RING_MAX_OF_HBM)
    if ring_bps > RING_MAX_OF_HBM * PEAK_HBM_BPS:
        fail(f"the 'torch' memory leg streams {ring_bps:.4g} B/s, above "
             f"{RING_MAX_OF_HBM} x the HBM rate: it reads L2")

    targets = {hw.name: predict(loaded, hw).ttc_max
               for hw in (get_spec(loaded.meta["ref_hw"]), H100_SXM)}
    for backend, fused in MAIN_PATH_RUNS:
        em = Emulator(calib=calib, backend=backend)
        sched = em.compile(loaded)
        table = [row for s in sched.segments for row in s.table.tolist()]
        ci = sum(r[0] for r in table)
        mi = sum(r[1] for r in table)
        want = planned_counts(em, loaded, fused)
        zero_counters()
        t0 = time.perf_counter()
        rep = em.emulate(loaded, fused=fused)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = counters()
        if fused:
            want_mode = "fused"
            want_disp = sum(1 for s in sched.segments
                            if s.compute_iters or s.memory_iters)
        else:
            want_mode = "per_sample"
            want_disp = sum((r[0] > 0) + (r[1] > 0) for r in table)
        # kernels run on one stream and do not overlap: the device is busy
        # for the iterations times the device time of each, or, for the
        # segment kernel, for its device time at this table
        if backend == "cuda" and fused:
            busy_s = rows["segment"]["ms"] / 1e3
        else:
            busy_s = (ci * per_iter_ms[backend][0]
                      + mi * per_iter_ms[backend][1]) / 1e3
        emit("main_path", step="emulate", backend=backend, fused=fused,
             mode=rep.mode, ttc_s=rep.ttc_s, wall_s=wall,
             n_samples=rep.n_samples, n_dispatches=rep.n_dispatches,
             compute_iters=ci, compute_legs=compute_legs(table),
             memory_iters=mi, counters=got, device_busy_s=busy_s,
             busy_share=busy_s / rep.ttc_s,
             achieved_flops_per_s=rep.consumed.flops / rep.ttc_s,
             achieved_bytes_per_s=rep.consumed.hbm_bytes / rep.ttc_s,
             predicted_ttc_s=targets)
        name = f"{backend} {want_mode}"
        if rep.consumed != totals:
            fail(f"{name}: consumed {rep.consumed} != totals {totals}")
        if rep.mode != want_mode or rep.n_dispatches != want_disp:
            fail(f"{name}: mode {rep.mode} / {rep.n_dispatches} "
                 f"dispatches, want {want_mode} / {want_disp}")
        if got != want:
            fail(f"{name}: kernel counters {got}, want {want}")
        if rep.n_samples != len(loaded.samples):
            fail(f"{name}: {rep.n_samples} samples replayed")
        if backend == "cuda" and not fused:
            if (want["segment"] or not want["burn_tile"]
                    or not want["stream_ring"] or want["burn_iters"] != ci
                    or want["ring_passes"] != mi):
                fail(f"{name}: the path does not launch {want}")
            rows["burn_tile"]["launches"] = got["burn_tile"]
            rows["burn_tile"]["iterations"] = got["burn_iters"]
            rows["stream_pass"]["launches"] = got["stream_ring"]
            rows["stream_pass"]["passes"] = got["ring_passes"]
        elif backend == "cuda":
            if (not want["segment"] or want["segment_iters"] != ci
                    or want["segment_passes"] != mi or want["burn_tile"]):
                fail(f"{name}: the path does not launch {want}")
            rows["segment"]["launches"] = got["segment"]
            rows["segment"]["iterations"] = got["segment_iters"]
            rows["segment"]["passes"] = got["segment_passes"]

    # which kernels each run launches: each replays a depth-cut profile of
    # the same widths (1 request of 8 prompt and 2 generated tokens) once
    # to warm up, then once under the profiler.  Its kernel time over wall
    # time is the cut run's, not the main path's (the once-per-sample sync
    # weighs more in a short run).  The trace must hold every launch the
    # wrappers counted.  On the card this was written for, the profiler
    # has dropped kernel records as out of its capture window, more often
    # after large traced sessions (PERF.md, open questions): the "cuda"
    # runs are traced first, and a trace that misses launches is taken
    # again, up to TRACE_ATTEMPTS times, each attempt printed
    cut = generate("serving_traffic", n_requests=1, prefill_tokens=8,
                   decode_tokens=2, seed=0, **QWEN2_7B_SERVING)
    for backend, fused in sorted(MAIN_PATH_RUNS,
                                 key=lambda run: run[0] != "cuda"):
        em = Emulator(calib=calib, backend=backend)
        em.emulate(cut, fused=fused)
        for attempt in range(1, TRACE_ATTEMPTS + 1):
            zero_counters()
            wall, busy, kernels = device_time(
                torch, lambda: em.emulate(cut, fused=fused))
            got = counters()
            traced = {c: sum(k[2] for k in kernels if sym in k[0])
                      for c, sym in TRACED_KERNELS}
            counted = {c: got[c] for c, _ in TRACED_KERNELS}
            emit("main_path", step="trace_cut_run", backend=backend,
                 fused=fused, attempt=attempt, wall_s=wall, kernel_s=busy,
                 cut_run_busy_share=busy / wall, top_kernels=kernels[:5],
                 traced_launches=traced, counted_launches=counted)
            if traced == counted:
                break
        else:
            fail(f"trace_cut_run {backend} fused={fused}: {TRACE_ATTEMPTS} "
                 f"traces missed launches of the port's kernels: the last "
                 f"holds {traced}, the counters {counted}")

    # the "torch" backend's segment loop on the card agrees with the host on
    # a small table (tile 64, 256 KiB block)
    seg = FusedSegment(table=[[3, 2, 0], [0, 1, 0], [5, 0, 0]])
    on_card = SegmentRunner(tile=64, block_bytes=1 << 18).launch(seg)
    on_host = SegmentRunner(tile=64, block_bytes=1 << 18,
                            device="cpu").launch(seg)
    err = max((a.cpu() - b).abs().max().item()
              for a, b in ((on_card.y, on_host.y),
                           (on_card.slot, on_host.slot)))
    emit("main_path", step="segment_vs_host", max_abs_err=err)
    if not err <= 1e-5:
        fail(f"fused segment on the card differs from the host by {err}")
    return calib, per_iter_ms


def collective_profile(ici_per_step: float):
    """``training_scan`` at Qwen2-7B's per-step amounts with the wire bytes
    of a 2-way data-parallel step (COLLECTIVE_CUTS)."""
    from repro_torch.scenarios import generate
    tokens = COLLECTIVE_CUTS["tokens_per_step"]
    return generate("training_scan", n_steps=COLLECTIVE_CUTS["n_steps"],
                    flops_per_step=6 * QWEN2_7B_PARAMS * tokens,
                    hbm_per_step=(QWEN2_7B_PARAMS
                                  * QWEN2_7B_TRAIN_BYTES_PER_PARAM),
                    ici_per_step=ici_per_step,
                    ckpt_every=COLLECTIVE_CUTS["ckpt_every"])


def report_dump(rep) -> dict:
    """A report's deterministic fields (everything but its times)."""
    d = rep.to_dict()
    d.pop("ttc_s")
    d.pop("per_sample_s")
    return d


def phase_collective(torch, np, calib, build_info):
    """The collective atom on the card, its mesh's shards all on cuda:0:
    ``csrc/collective.cu`` (the per-sample collective) and the segment
    kernel's wire leg against their plain versions for each kind on a
    2-shard mesh, ``collective.cu``'s shape cases, the 1-shard fold, the
    segment kernel's registers and spills; the wire leg's latency floor
    (``wire_round_trips``) and its device time a step at 2 and 4 shards;
    then the path: a Qwen2-7B-sized ``training_scan`` with a 2-way
    data-parallel step's wire bytes replayed fused (one segment launch,
    the device's counts of all three legs the table's) and per sample (one
    collective launch a wire leg, at a tenth of the wire bytes), and a
    2-worker process fleet whose workers build their own mesh and replay
    the mesh-bound bundle like this process; last, ``collective.cu`` at
    the operand the per-sample run gave it, against its plain version and
    timed.  Returns the kernels line's ``collective`` and ``segment_wire``
    rows."""
    from repro_torch.core import H100_SXM, Emulator, predict
    from repro_torch.core.atoms import (COLL_BLOCK_ELEMS, CollectiveAtom,
                                        CollectiveQuant)
    from repro_torch.fleet import (FleetConfig, MeshSpec, ProcessFleet,
                                   run_process_fleet)
    from repro_torch.kernels.collective import kernel as wk, ref as wref
    from repro_torch.kernels.memory_atom import kernel as mk
    from repro_torch.kernels.segment import kernel as sk, ref as sref
    from repro_torch.launch.mesh import describe, make_mesh
    started = time.perf_counter()
    dev = torch.device("cuda")
    rng = np.random.default_rng(11)
    card = torch.cuda.get_device_name(0)
    mesh = make_mesh((2,), ("data",), dev)
    emit("collective", step="mesh", mesh=describe(mesh),
         shared=mesh.shared, device=str(mesh.device),
         devices=[str(d) for d in mesh.devices.flat])

    # 1. each kind against its plain version on the 2-shard mesh: the
    # per-sample collective, and the segment kernel's wire leg on the
    # fused carry after a burn and a ring leg
    coll_err = wire_err = 0.0
    table = np.asarray([[2, 1, 3], [0, 0, 0], [0, 0, 5], [1, 2, 0]],
                       np.int32)
    for kind in wref.KINDS:
        x = torch.from_numpy(rng.standard_normal((2, 4096)).astype(
            np.float32)).to(dev)
        got = wk.collective(x, dim=0, kind=kind)
        want = wref.collective(x, dim=0, kind=kind)
        w = torch.from_numpy(rng.standard_normal(
            (2, COLL_BLOCK_ELEMS)).astype(np.float32)).to(dev)
        xs = torch.from_numpy((rng.standard_normal((256, 256)) * 0.1)
                              .astype(np.float32)).to(dev)
        ring = mk.Ring(1 << 18, dev, slots=3)
        want_w, want_ring = w.clone(), ring.data.clone()
        want_y = sref.run_segment(table, xs, want_ring, w=want_w, kind=kind)
        run = sk.run_segment(table, xs, ring, w, kind)
        torch.cuda.synchronize()
        run.settle()
        errs = {"collective": (got - want).abs().max().item(),
                "segment_wire": (run.w - want_w).abs().max().item(),
                "segment_burn": (run.y - want_y).abs().max().item()}
        ok = (got.shape == want.shape
              and torch.allclose(got, want, rtol=COLL_TOL, atol=COLL_TOL)
              and torch.allclose(run.w, want_w, rtol=COLL_TOL, atol=COLL_TOL)
              and torch.allclose(run.y, want_y, rtol=BURN_TOL, atol=BURN_TOL)
              and torch.equal(ring.data, want_ring))
        emit("collective", step="against_plain", kind=kind,
             max_abs_err=errs, tolerance=COLL_TOL, ok=ok)
        if not ok:
            fail(f"collective {kind}: max abs err {errs} beyond "
                 f"{COLL_TOL}")
        coll_err = max(coll_err, errs["collective"])
        wire_err = max(wire_err, errs["segment_wire"])
    for shape, dim in COLL_CASES:
        x = torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev)
        for kind in wref.KINDS:
            got = wk.collective(x, dim=dim, kind=kind)
            want = wref.collective(x, dim=dim, kind=kind)
            ok = got.shape == want.shape and torch.allclose(
                got, want, rtol=COLL_TOL, atol=COLL_TOL)
            err = (got - want).abs().max().item() if ok else float("inf")
            if not ok:
                fail(f"collective {kind} at {shape} along {dim}: max abs "
                     f"err {err} beyond {COLL_TOL}")
            coll_err = max(coll_err, err)
    emit("collective", step="shape_cases", cases=COLL_CASES,
         max_abs_err=coll_err, tolerance=COLL_TOL, ok=True)
    seg_ptxas = {k: ptxas_numbers(v["ptxas"]) for k, v in build_info.items()
                 if "segment_kernel" in k}
    emit("collective", step="segment_registers", ptxas=seg_ptxas)
    if len(seg_ptxas) != len(sk.TILES) or any(
            p["spill_bytes"] or not p["registers"] or p["registers"] > 255
            for p in seg_ptxas.values()):
        fail(f"segment kernel: registers or spills {seg_ptxas}")

    # a 1-shard axis all-reduces nothing: no steps, no plan, no launch
    one = make_mesh((1,), ("data",), dev)
    before = wk.launches
    plan = CollectiveAtom(one, backend="cuda").plan(QWEN2_7B_TRAIN_WIRE)
    em1 = Emulator(calib=calib, backend="cuda", mesh=one)
    folded = em1.compile(collective_profile(QWEN2_7B_TRAIN_WIRE))
    steps1 = sum(int(t[:, 2].sum()) for t in
                 (seg.table for seg in folded.segments))
    emit("collective", step="one_shard", plan_amount=plan.amount,
         iters=CollectiveQuant(n=1).iters_for(QWEN2_7B_TRAIN_WIRE),
         table_steps=steps1, mesh_bound=folded.mesh_bound)
    if plan.amount or plan.launch() is not None or wk.launches != before \
            or steps1 or folded.mesh_bound:
        fail("collective: a 1-shard all-reduce did not fold to nothing")
    del em1

    # 2. the wire leg's latency floor: one step's dependent round trip
    # through L2 and through the peer CTA's shared memory
    # (csrc/l2_probe.cu); then device times a step on the fused carry (n x
    # 128 KiB, n = 2 and 4): the segment's wire leg alone (its carry in
    # the CTAs' shared memory), the plain version and the library call;
    # the byte bound reads and writes the carry once a step at L2's read
    # rate (csrc/l2_probe.cu, this run), kept for comparison across PRs
    grid = sk.grid_info(sk.TILES[0], dev)["grid"]
    floor = wire_round_trips(torch, grid)
    emit("collective", step="wire_round_trips", grid=grid, steps=20000,
         kind="all-reduce", shards=2, **floor)
    l2 = l2_read_rates(torch)
    l2_bps = max(l2.values())
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    leg = np.asarray([[0, 0, 20000]], np.int32)
    wire = {}
    for n in WIRE_SHARDS:
        w = torch.ones((n, COLL_BLOCK_ELEMS), dtype=torch.float32,
                       device=dev)
        plain_ms = graph_ms(lambda: chain(lambda y: wref.loop_step(
            y, dim=0, kind="all-reduce"), w, 100), 100)
        library_ms = graph_ms(lambda: repeat(lambda: w.copy_(
            w.mean(0, keepdim=True).expand_as(w)), 100), 100)
        times = []
        for _ in range(3):
            start.record()
            run = sk.run_segment(leg, None, None, w, "all-reduce")
            end.record()
            end.synchronize()
            run.settle()
            times.append(start.elapsed_time(end) / int(leg[0, 2]))
        if not torch.equal(w, torch.ones_like(w)):
            fail(f"segment wire leg, {n} shards: the all-reduce of ones "
                 "did not stay ones")
        step_bytes = 2 * w.numel() * 4
        wire[n] = {"ms": min(times), "ms_each": times, "plain_ms": plain_ms,
                   "library_ms": library_ms, "bytes_per_step": step_bytes,
                   "bound_ms": step_bytes / l2_bps * 1e3,
                   "smem_bytes": sk.grid_info(
                       sk.TILES[0], dev, tuple(w.shape))["smem_bytes"]}
        emit("collective", step="step_times", shards=n,
             l2_read_bytes_per_s=l2, **wire[n])
    wire_ms = wire[2]["ms"]
    plain_ms, library_ms = wire[2]["plain_ms"], wire[2]["library_ms"]
    bound_ms = wire[2]["bound_ms"]

    # 3. the path: fused at full width and amounts, then per sample at the
    # cut's wire bytes (and fused at the cut, like with like)
    em = Emulator(calib=calib, backend="cuda", mesh=mesh)
    quant = em.collective.quant()
    full = collective_profile(QWEN2_7B_TRAIN_WIRE)
    cut = collective_profile(COLLECTIVE_CUTS["per_sample_ici_per_step"])
    emit("collective", step="profile", reduced=COLLECTIVE_CUTS,
         ici_per_step=QWEN2_7B_TRAIN_WIRE, n_samples=len(full.samples),
         flops=full.totals.flops, hbm_bytes=full.totals.hbm_bytes,
         ici_bytes=full.totals.ici_total, quant=quant.to_dict())
    results = {}
    # the shapes the path gives collective.cu, recorded as it launches
    operands, collective_kernel = [], wk.collective

    def seen_collective(x, **kw):
        operands.append((tuple(x.shape), kw))
        return collective_kernel(x, **kw)

    for name, prof, fused in (("fused", full, True),
                              ("per_sample_cut", cut, False),
                              ("fused_cut", cut, True)):
        sched = em.compile(prof)
        tables = [seg.table for seg in sched.segments]
        steps = sum(int(t[:, 2].sum()) for t in tables)
        want = planned_counts(em, prof, fused)
        zero_counters()
        wk.collective = seen_collective
        t0 = time.perf_counter()
        try:
            rep = em.emulate(prof, fused=fused)
            torch.cuda.synchronize()
        finally:
            wk.collective = collective_kernel
        wall = time.perf_counter() - t0
        got = counters()
        pred = predict(prof, H100_SXM)
        emulated_want = (quant.emulated_bytes(steps) if fused else
                         rep.emulated_ici_bytes)
        emit("collective", step="emulate", run=name, fused=fused,
             mode=rep.mode, ttc_s=rep.ttc_s, wall_s=wall,
             n_dispatches=rep.n_dispatches,
             n_collective_dispatches=rep.n_collective_dispatches,
             emulated_ici_bytes=rep.emulated_ici_bytes,
             ici_bytes=prof.totals.ici_total, table_steps=steps,
             counters=got, predicted_ttc_s=pred.ttc_max,
             predicted_collective_s=pred.terms.collective_s,
             nvlink_s=prof.totals.ici_total / NVLINK_BPS,
             emulated_wire_l2_s=steps * wire_ms / 1e3 if fused else None)
        if rep.consumed != prof.totals:
            fail(f"collective {name}: consumed {rep.consumed}, want "
                 f"{prof.totals}")
        if got != want:
            fail(f"collective {name}: kernel counters {got}, want {want}")
        if fused and (not got["segment_wire"] or got["segment_steps"] != steps
                      or rep.emulated_ici_bytes != emulated_want
                      or rep.n_dispatches != want["segment"]):
            fail(f"collective {name}: {got['segment_steps']} steps, "
                 f"emulated {rep.emulated_ici_bytes}, want {steps} steps, "
                 f"{emulated_want}")
        if not fused and (not got["collective"] or abs(
                rep.emulated_ici_bytes - prof.totals.ici_total)
                > 0.05 * prof.totals.ici_total):
            fail(f"collective {name}: {got['collective']} launches, "
                 f"emulated {rep.emulated_ici_bytes} of "
                 f"{prof.totals.ici_total}")
        results[name] = (rep, got)

    # 4. a 2-worker process fleet: each worker builds its own 2-shard mesh
    # on the card and replays the mesh-bound bundle of the full profile
    parent = Emulator(calib=calib, backend="cuda")
    mesh_spec = MeshSpec(shape=(2,), axes=("data",))
    in_process = em.replay(parent.compile(full, mesh_spec=mesh_spec),
                           command=full.command, planned=full.totals)
    spec = FleetConfig.process(max_workers=2, mesh=mesh_spec).worker_spec(
        parent.spec(), device=str(parent.device))
    spawned = time.monotonic()
    with ProcessFleet(2, spec) as pool:
        infos = pool.warmup(timeout=300.0)
        spawn_to_ready = sorted(p.last_seen - spawned for p in pool._peers)
        warm = run_process_fleet(parent, [full, full], fleet=pool,
                                 mesh_spec=mesh_spec)
    emit("collective", step="process_fleet", workers=warm.max_workers,
         ready=infos, spawn_to_ready_s=spawn_to_ready, wall_s=warm.wall_s,
         ttc_s=[r.ttc_s for r in warm.reports],
         in_process_ttc_s=in_process.ttc_s)
    want_mesh = {"shape": [2], "axes": ["data"], "shared": True}
    if [(i["device"], i["mesh"]) for i in infos] != [(card, want_mesh)] * 2:
        fail(f"collective process fleet: workers {infos}")
    for r in warm.reports:
        if report_dump(r) != report_dump(in_process):
            fail(f"collective process fleet: report {report_dump(r)}, "
                 f"in process {report_dump(in_process)}")
    del em, parent, in_process

    # 5. collective.cu at the operand the per-sample run gave it (random
    # values in its shape), against its plain version, and timed beside
    # the plain version and the library call; the bound reads the operand
    # once and writes the output once at HBM's rate
    shapes = sorted({(shape, tuple(sorted(kw.items())))
                     for shape, kw in operands})
    if len(shapes) != 1:
        fail(f"collective: the per-sample run gave collective.cu "
             f"{shapes}, want one all-reduce operand")
    shape, kw = shapes[0][0], dict(shapes[0][1])
    if kw != {"dim": 0, "kind": "all-reduce"}:
        fail(f"collective: the per-sample run launched {kw}")
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)
    big_ms = event_ms(lambda: wk.collective(x, **kw), reps=5, warmup=1)
    big_plain_ms = event_ms(lambda: wref.collective(x, **kw), reps=5,
                            warmup=1)
    big_library_ms = event_ms(
        lambda: x.sum(0, keepdim=True).expand_as(x).contiguous(), reps=5,
        warmup=1)
    got = wk.collective(x, **kw)
    want = wref.collective(x, **kw)
    big_bytes = (x.numel() + got.numel()) * 4
    got.sub_(want).abs_()          # in place: the operand is gigabytes
    big_err = got.max().item()
    big_ok = bool((got <= want.abs_().mul_(COLL_TOL).add_(COLL_TOL)).all())
    big_bound_ms = big_bytes / PEAK_HBM_BPS * 1e3
    emit("collective", step="per_sample_operand", shape=list(shape),
         bytes=big_bytes, max_abs_err=big_err, tolerance=COLL_TOL,
         ok=big_ok, ms=big_ms, plain_ms=big_plain_ms,
         library_ms=big_library_ms, bound_ms=big_bound_ms)
    if not big_ok:
        fail(f"collective at {list(shape)}: max abs err {big_err} beyond "
             f"{COLL_TOL}")
    del x, got, want
    torch.cuda.empty_cache()
    emit("collective", step="done", seconds=time.perf_counter() - started)

    def resources(word):
        return {k: v["ptxas"] for k, v in build_info.items() if word in k}

    fused_got = results["fused"][1]
    return {
        "collective": {
            "name": "collective", "route": "cuda",
            "source": "src/repro_torch/csrc/collective.cu",
            "replaces": "src/repro/core/atoms.py:487 (CollectiveAtom."
                        "_coll_fn: lax.psum, all_gather and ppermute under "
                        "shard_map; not a Pallas kernel)",
            "launches": results["per_sample_cut"][1]["collective"],
            "max_abs_err": max(coll_err, big_err), "ms": big_ms,
            "plain_ms": big_plain_ms, "bound_ms": big_bound_ms,
            "bound_by": "bytes", "bound_rate": "HBM peak",
            "library_ms": big_library_ms,
            "library": "x.sum(0, keepdim=True).expand_as(x).contiguous()",
            "shape": list(shape), "ptxas": resources("collective"),
            "unit": "one per-sample all-reduce launch on the per-sample "
                    "run's operand",
            "timing": "device time: CUDA events around 5 launches",
        },
        "segment_wire": {
            "name": "segment_wire", "route": "cuda",
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "bound_rate": "L2 read rate of csrc/l2_probe.cu, this run",
            "library_ms": library_ms,
            "library": "x.copy_(x.mean(0, keepdim=True).expand_as(x))",
            "shape": [2, COLL_BLOCK_ELEMS],
            "ptxas": resources("segment_kernel"),
            "nvlink_ms_a_step": quant.wire_bytes_per_iter / NVLINK_BPS * 1e3,
            "latency_floor": floor,
            "latency_floor_ms": floor[f"peer_smem_{grid}ctas"]["us"] / 1e3,
            "by_shards": wire,
            "source": "src/repro_torch/csrc/segment.cu",
            "device_code": "src/repro_torch/csrc/coll.cuh",
            "replaces": "src/repro/core/schedule.py:357 (the collective "
                        "block of SegmentRunner._fn's scan; not a Pallas "
                        "kernel)",
            "launches": fused_got["segment_wire"],
            "steps": fused_got["segment_steps"], "max_abs_err": wire_err,
            "ms": wire_ms,
            "unit": "one all-reduce step of the segment kernel's wire leg "
                    "on its 2 x 128 KiB carry (kept in the CTAs' shared "
                    "memory), in a 20000-step launch",
            "timing": "device time: CUDA events around one launch, the "
                      "best of 3; plain and library: CUDA graph of 100 "
                      "steps",
        },
    }


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


def phase_fleet(torch, calib, per_iter_ms):
    """Fleet emulation on the card: the job set of ``fleet_jobs`` through
    ``run_fleet`` on 2 threads of the ``"cuda"`` kernel backend, on warm
    pools of 1 and 2 worker processes replaying ``"cuda"`` segments against
    the same profiles replayed in this process, as a fork-join
    ``WorkloadDag``, and under a seeded chaos policy that kills each worker
    once; then the H100's ``predict_fleet`` row beside the measured wall
    time."""
    from repro_torch.core import H100_SXM, Emulator
    from repro_torch.fleet import (BundleTiming, ChaosPolicy, FleetConfig,
                                   ProcessFleet, critical_path,
                                   run_process_fleet)
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

    # 1. thread fleet on the kernel backend: segments fused, storage runs
    # per sample
    em = Emulator(calib=calib, backend="cuda")
    want = dict.fromkeys(counters(), 0)
    for p in profiles:
        for k, v in planned_counts(em, p).items():
            want[k] += v
    ci = want["segment_iters"] + want["burn_iters"]
    mi = want["segment_passes"] + want["ring_passes"]
    zero_counters()
    res = run_fleet(jobs, config=FleetConfig.thread(max_workers=2),
                    emulator=em, hw=H100_SXM)
    torch.cuda.synchronize()
    got = counters()
    fleet = res.fleet
    busy_s = (ci * per_iter_ms["cuda"][0] + mi * per_iter_ms["cuda"][1]) / 1e3
    emit("fleet", step="thread_cuda", workers=fleet.max_workers,
         wall_s=fleet.wall_s, serial_s=fleet.serial_s,
         speedup=fleet.speedup, compute_iters=ci, memory_iters=mi,
         counters=got, device_busy_s=busy_s,
         busy_share=busy_s / fleet.wall_s, cache_stats=fleet.cache_stats)
    for (name, _), r, p in zip(jobs, res.results, profiles):
        if r.report.consumed != p.totals or r.profile.totals != p.totals \
                or r.report.mode != "fused":
            fail(f"thread fleet: {name} consumed {r.report.consumed} "
                 f"({r.report.mode}), planned {p.totals}")
    if got != want or not got["segment"]:
        fail(f"thread fleet: kernel counters {got}, want {want}")
    pred = res.predictions
    emit("fleet", step="predict", hw=pred["hw"],
         predicted_serial_s=pred["serial_s"],
         predicted_concurrent_lower_s=pred["concurrent_lower_s"],
         dominant=pred["dominant_total"], measured_wall_s=fleet.wall_s)
    if pred["hw"] != H100_SXM.name or pred["n_profiles"] != len(jobs):
        fail(f"fleet prediction is for {pred['hw']}, {pred['n_profiles']} "
             "profiles")

    # 2. warm pools of 1 and 2 worker processes replaying "cuda" segments,
    # against the same profiles replayed back to back here (a worker's
    # segment runner checks each launch's device counters and raises on a
    # short burn)
    em = Emulator(calib=calib, backend="cuda")
    t0 = time.perf_counter()
    refs = [em.emulate(p, fused=True) for p in profiles]
    torch.cuda.synchronize()
    in_process_s = time.perf_counter() - t0
    em.storage.cleanup()
    emit("fleet", step="in_process_cuda", wall_s=in_process_s,
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
        emit("fleet", step="process_cuda", workers=warm.max_workers,
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
    scenarios CLI as a subprocess.  The pools, HTTP and the agent replay
    fused ``"cuda"`` segments in their workers (each worker checks its
    launches' device counters); this process launches segments only for
    its in-process reference replay."""
    import urllib.request

    from repro_torch.core import Emulator, ReportFold
    from repro_torch.fleet import ChaosPolicy, FleetConfig
    from repro_torch.obs import Event, parse_promtext, validate_trace
    from repro_torch.obs import now as obs_now
    from repro_torch.scenarios import generate
    from repro_torch.service import PoissonArrivals, StandingFleet, run_load
    from repro_torch.service.http import make_server

    started = time.perf_counter()
    card = torch.cuda.get_device_name(0)
    params = dict(QWEN2_7B_SERVING, seed=0, **FLEET_CUTS["serving_traffic"])
    profile = generate("serving_traffic", **params)
    em = Emulator(calib=calib, backend="cuda")
    zero_counters()
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

    in_process = counters()
    if in_process != planned_counts(em, profile) or not in_process["segment"]:
        fail(f"service: the in-process replay counted {in_process}")
    zero_counters()

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

    # every replay of steps 1-4 ran in a worker process, where its
    # launches are counted and checked
    launches = counters()
    emit("service", step="done", in_process_replay_counters=in_process,
         launches_since=launches, seconds=time.perf_counter() - started)
    if any(launches.values()):
        fail(f"service: kernels launched in this process: {launches}")


def phase_serve(torch, np, rows):
    """Qwen2-7B at full width through the port's serving path: a depth-cut
    float32 check of the kernel against dense attention, then the full
    model in bf16 serving 4 requests under the RuntimeProfiler, its profile
    stored, reloaded and replayed by the emulator on the kernel backend,
    and a report of the kernel against dense attention at full depth.
    Returns the host's calibration it measured."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.configs.run import SERVE_RUN, RunConfig
    from repro_torch.core import (Emulator, ProfileStore, RuntimeProfiler,
                                  calibrate)
    from repro_torch.kernels.flash_attention import kernel as fk
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
             busy_share=busy / wall, top_kernels=top[:5])
        tok, cache = engine.prefill(params, batch)

        def decode4():
            nonlocal tok, cache
            for _ in range(4):
                tok, cache = engine.decode(params, tok, cache)

        wall, busy, top = device_time(torch, decode4)
        emit("serve", step="trace_decode_4_steps", wall_s=wall,
             kernel_s=busy, busy_share=busy / wall, top_kernels=top[:5])
    del cache

    # -- the profile: stored, reloaded, replayed on the kernel backend -----
    with tempfile.TemporaryDirectory() as d:
        store = ProfileStore(d)
        store.add(prof)
        loaded = store.latest(prof.command, prof.tags)
    if loaded is None or loaded.totals != prof.totals:
        fail("the serve profile did not round-trip through the store")
    em = Emulator(calib=calibrate(), backend="cuda")
    want = planned_counts(em, loaded)
    zero_counters()
    rep = em.emulate(loaded)
    torch.cuda.synchronize()
    got = counters()
    emit("serve", step="replay", backend="cuda", mode=rep.mode,
         n_samples=rep.n_samples, n_dispatches=rep.n_dispatches,
         ttc_s=rep.ttc_s, profiled_wall_s=prof.meta["wall_s"],
         flops=loaded.totals.flops, counters=got,
         host_flops_per_cpu_s=host.flops_per_s)
    if not same_amounts(rep.consumed, loaded.totals):
        fail(f"serve replay consumed {rep.consumed} != {loaded.totals}")
    if got != want or rep.mode != "fused":
        fail(f"serve replay ({rep.mode}) counted {got}, want {want}")

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
    del full, last
    return host, {"model": model, "params": params, "batch": batch}


def qwen2_dot_flops(cfg, B: int, S: int, logits_rows: int) -> float:
    """Analytic matmul flops of a dense forward over B x S tokens: 2 x the
    non-embedding matmul parameters (q, k, v, o and the three MLP
    matrices of every layer) x the tokens, plus the logits product over
    ``logits_rows`` rows."""
    D, F = cfg.d_model, cfg.d_ff
    q = cfg.num_heads * cfg.head_dim
    kv = cfg.num_kv_heads * cfg.head_dim
    per_layer = D * q + 2 * D * kv + q * D + 3 * D * F
    return (2.0 * per_layer * cfg.num_layers * B * S
            + 2.0 * logits_rows * D * cfg.vocab_size)


def timed_s(torch, fn, reps: int) -> float:
    """Median host seconds of ``reps`` calls of ``fn``, each synchronised."""
    import statistics
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return statistics.median(out)


def replay_static(torch, calib, name, prof, step_s, trace_s,
                  dev=None) -> None:
    """Replay a static profile fused on the ``"cuda"`` backend: one segment
    launch, device counts the plan's, consumed flops within
    STATIC_REPLAY_TOL of the profile's; print the paper's fidelity
    numbers beside it (no bound on their ratios)."""
    from repro_torch.core import H100_SXM, Emulator, predict
    em = Emulator(calib=calib, backend="cuda", device=dev)
    want = planned_counts(em, prof)
    zero_counters()
    rep = em.emulate(prof)
    torch.cuda.synchronize()
    got = counters()
    rel = abs(rep.consumed.flops - prof.totals.flops) / prof.totals.flops
    emit("static", step="replay", profile=name, mode=rep.mode,
         n_samples=rep.n_samples, counters=got,
         consumed_flops=rep.consumed.flops, profile_flops=prof.totals.flops,
         rel_flops_err=rel, tol=STATIC_REPLAY_TOL, emulated_ttc_s=rep.ttc_s,
         predicted_h100_ttc_max_s=predict(prof, H100_SXM).ttc_max,
         measured_step_s=step_s, profiled_step_s=trace_s,
         profiling_overhead=trace_s / step_s - 1.0)
    if rep.mode != "fused" or want["segment"] != 1 or got != want:
        fail(f"static {name} replay ({rep.mode}) counted {got}, want {want}"
             f" in one segment launch")
    if not rel <= STATIC_REPLAY_TOL:
        fail(f"static {name} replay consumed {rep.consumed.flops} flops, "
             f"the profile {prof.totals.flops}")


def phase_static(torch, np, calib, served, dev=None) -> None:
    """The static watcher (``profile_step``) at Qwen2-7B's widths: (a) the
    serve phase's full-depth bf16 prefill of its 4 prompts on the card,
    its dot flops against the analytic count and its 28 flash launches;
    (b) the same step on meta tensors, the same cost bit for bit, no
    launch; (c) the train phase's 4-layer step (TRAIN_RUN, 1 x 4096
    tokens) on the card, forward and backward samples; (d) each profile
    replayed fused on the ``"cuda"`` emulator; (e) emulated and predicted
    times beside the measured step and the profiling overhead.  Takes the
    serve phase's weights out of ``served`` and frees them before (c).
    ``dev`` is the card unless named (a CPU rehearsal names the CPU)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.configs.run import TRAIN_RUN
    from repro_torch.core import profile_step
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ref as fref
    from repro_torch.models.model_zoo import build_model
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.serve.step import make_prefill_step
    from repro_torch.train.step import init_train_state, make_train_step
    dev = dev or torch.device("cuda")
    model, params, batch = (served.pop(k) for k in ("model", "params",
                                                    "batch"))
    cfg = model.cfg
    B, S = batch["tokens"].shape
    prefill = make_prefill_step(model, S + SERVE_NEW_TOKENS)

    def prefill_fn(p, b):
        with torch.inference_mode():
            return prefill(p, b)

    # -- (a) the full-depth prefill on the card ---------------------------
    prefill_fn(params, batch)
    fk.launches = 0
    prof, cost = profile_step(prefill_fn, params, batch,
                              command="static-prefill-qwen2-7b",
                              tags={"prompts": "2048/1536/1024/512"},
                              device=dev)
    launches = fk.launches
    step_s = timed_s(torch, lambda: prefill_fn(params, batch),
                     STATIC_TIMED_STEPS)
    flash = cfg.num_layers * fref.flops(B * cfg.num_heads, S, S,
                                        cfg.head_dim, causal=True)
    analytic = qwen2_dot_flops(cfg, B, S, B) + flash
    rel = abs(cost.dot_flops - analytic) / analytic
    labels = [s_.label for s_ in prof.samples]
    want_labels = ["glue"] + ["scan:layers"] * cfg.num_layers + ["glue"]
    emit("static", step="prefill_on_card", batch=B, seq=S,
         n_samples=len(labels), labels=sorted(set(labels)),
         flops=cost.flops, dot_flops=cost.dot_flops,
         analytic_dot_flops=analytic, flash_flops=flash, rel_dot_err=rel,
         tol=STATIC_DOT_TOL, dot_bytes=cost.dot_bytes,
         hbm_bytes_upper=cost.hbm_bytes, transcendentals=cost.transcendentals,
         flash_launches=launches, memory=prof.meta["memory"],
         trace_s=prof.meta["trace_s"], step_s=step_s,
         op_flops=cost.op_flops)
    if launches != cfg.num_layers:
        fail(f"static prefill: {launches} flash launches, want "
             f"{cfg.num_layers}")
    if labels != want_labels:
        fail(f"static prefill: samples {labels}, want glue, "
             f"{cfg.num_layers} layers, glue")
    if not rel <= STATIC_DOT_TOL:
        fail(f"static prefill: dot flops {cost.dot_flops}, analytic "
             f"{analytic}")

    # -- (b) the same step on meta tensors ---------------------------------
    fk.launches = 0
    mprof, mcost = profile_step(prefill_fn, params, batch,
                                command="static-prefill-qwen2-7b",
                                tags={"prompts": "2048/1536/1024/512"},
                                device="meta")
    same = mcost == cost and [s_.to_dict() for s_ in mprof.samples] == \
        [s_.to_dict() for s_ in prof.samples]
    emit("static", step="prefill_on_meta", identical=same,
         flash_launches=fk.launches, trace_s=mprof.meta["trace_s"],
         temp_bytes=mprof.meta["memory"]["temp_bytes"])
    if not same or fk.launches:
        fail(f"static prefill on meta: identical {same}, "
             f"{fk.launches} launches")
    prefill_s = (step_s, prof.meta["trace_s"])
    del model, params, batch, prefill, mprof
    torch.cuda.empty_cache()

    # -- (c) the 4-layer train step on the card ----------------------------
    tcfg = dataclasses.replace(get_config("qwen2-7b"),
                               num_layers=TRAIN_LAYERS)
    tmodel = build_model(tcfg, TRAIN_RUN)
    state = init_train_state(tmodel, torch.Generator(dev).manual_seed(0),
                             device=dev)
    g = torch.Generator(dev).manual_seed(1)
    toks = torch.randint(0, tcfg.vocab_size, (1, TRAIN_SEQ + 1),
                         generator=g, device=dev, dtype=torch.int32)
    tbatch = {"tokens": toks[:, :-1].contiguous(),
              "targets": toks[:, 1:].contiguous()}
    step = make_train_step(tmodel, OptConfig())
    step(state, tbatch)
    tprof, tcost = profile_step(step, state, tbatch,
                                command="static-train-qwen2-7b-4l",
                                tags={"layers": str(TRAIN_LAYERS)},
                                device=dev)
    train_s = timed_s(torch, lambda: step(state, tbatch), STATIC_TIMED_STEPS)
    labels = [s_.label for s_ in tprof.samples]
    emit("static", step="train_step_on_card", layers=TRAIN_LAYERS,
         tokens=TRAIN_SEQ, n_samples=len(labels),
         runs={k: labels.count(k) for k in sorted(set(labels))},
         flops=tcost.flops, dot_flops=tcost.dot_flops,
         dot_bytes=tcost.dot_bytes, memory=tprof.meta["memory"],
         trace_s=tprof.meta["trace_s"], step_s=train_s)
    if labels.count("scan:layers") != TRAIN_LAYERS or \
            labels.count("scan:layers.grad") != TRAIN_LAYERS:
        fail(f"static train step: samples {labels}, want {TRAIN_LAYERS} "
             f"forward and {TRAIN_LAYERS} backward layers")
    del state, tbatch, step
    torch.cuda.empty_cache()

    # -- (d, e) replays -----------------------------------------------------
    replay_static(torch, calib, "prefill", prof, *prefill_s, dev=dev)
    replay_static(torch, calib, "train_step", tprof, train_s,
                  tprof.meta["trace_s"], dev=dev)


def dryrun_card_check(torch, name, cfg, shape, run, make_args, dev):
    """One cell that fits the card: the dry-run on a 1 x 1 mesh on meta,
    then the same step for real on ``dev`` with the arguments
    ``make_args(model)`` makes there.  Fails unless the argument bytes
    are the dry-run's, the card's counted flops within DRYRUN_FLOPS_TOL
    of the walker's and its peak of allocated memory (above what was
    allocated before the arguments) within DRYRUN_MEMORY_TOL of
    ``per_device_total``."""
    from torch.utils._pytree import tree_leaves
    from repro_torch.core import op_analysis
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_device_mesh
    mesh = fake_device_mesh((1, 1), ("data", "model"))
    low, meta = dryrun.lower_cell(cfg, shape, mesh, run)
    rec = dryrun.analyze(low, mesh, meta)
    step, _, _, _ = dryrun.cell_step(cfg, shape, None, run)
    torch.cuda.synchronize()
    pre = torch.cuda.memory_allocated(dev)
    args = make_args(dev)
    arg_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(args)
                    if isinstance(t, torch.Tensor))
    step(*args)                                   # warm-up: cuBLAS, caches
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    counter, out = op_analysis.count_ops(step, *args)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) - pre
    del out
    flops = counter.total.flops
    rel = abs(flops - rec["walker"]["flops"]) / rec["walker"]["flops"]
    predicted = rec["memory"]["per_device_total"]
    emit("dryrun", step="card_check", cell=name, mesh=rec["mesh"],
         argument_bytes=rec["memory"]["argument_bytes"],
         card_argument_bytes=arg_bytes, walker_flops=rec["walker"]["flops"],
         card_flops=flops, rel_flops_err=rel, tol=DRYRUN_FLOPS_TOL,
         predicted_bytes=predicted, card_peak_bytes=peak,
         peak_ratio=peak / predicted, memory_tol=DRYRUN_MEMORY_TOL,
         memory=rec["memory"], analysis_s=rec["walker"]["analysis_s"],
         card_counted_step_s=step_s)
    if arg_bytes != rec["memory"]["argument_bytes"]:
        fail(f"dryrun {name}: {arg_bytes} argument bytes on the card, "
             f"{rec['memory']['argument_bytes']} in the dry-run")
    if not rel <= DRYRUN_FLOPS_TOL:
        fail(f"dryrun {name}: the card counted {flops} flops, the dry-run "
             f"{rec['walker']['flops']}")
    if not abs(peak / predicted - 1.0) <= DRYRUN_MEMORY_TOL:
        fail(f"dryrun {name}: the card peaked at {peak} bytes, the dry-run "
             f"predicted {predicted}")
    del args
    torch.cuda.empty_cache()


def phase_dryrun(torch, dev=None) -> None:
    """The dry-run: (a) the production cells of DRYRUN_CELLS through
    ``dryrun.run_cell`` on fake meshes of 256 and 512 ranks, each
    artifact's memory, walker and seconds, and ``predict`` on the H100 of
    ``from_dryrun_artifact``; fails if a cell is not ok, if its mesh is
    not 256 or 512 devices, or if a decode cell's ``per_device_total``
    reaches DRYRUN_DEVICE_BYTES.  (b) ``dryrun_card_check`` of Qwen2-7B's
    prefill of SERVE_B x SERVE_S tokens at full depth (SERVE_RUN) and the
    train phase's TRAIN_LAYERS-layer step of 1 x TRAIN_SEQ tokens
    (TRAIN_RUN).  Ends the fake process group."""
    import dataclasses
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.run import SERVE_RUN, TRAIN_RUN
    from repro_torch.core import (H100_SXM, from_dryrun_artifact,
                                  predict_resources)
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import close_fake_world
    from repro_torch.models.model_zoo import build_model
    from repro_torch.train.step import init_train_state
    dev = dev or torch.device("cuda")
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="dryrun") as out:
        for arch, shape, multi_pod in DRYRUN_CELLS:
            t0 = time.perf_counter()
            rec = dryrun.run_cell(arch, shape, multi_pod, out)
            wall = time.perf_counter() - t0
            if not rec["ok"]:
                fail(f"dryrun {arch} {shape}: {rec.get('error')}\n"
                     f"{rec.get('traceback', '')}")
            if rec.get("skipped"):
                emit("dryrun", step="cell", arch=arch, shape=shape,
                     mesh_tag=rec["mesh_tag"], skipped=rec["skip_reason"],
                     wall_s=wall)
                continue
            walker = {k: v for k, v in rec["walker"].items()
                      if k != "top_ops"}
            pred = predict_resources(from_dryrun_artifact(rec), H100_SXM)
            emit("dryrun", step="cell", arch=arch, shape=shape,
                 mesh_tag=rec["mesh_tag"], n_devices=rec["n_devices"],
                 memory=rec["memory"], walker=walker,
                 analysis_s=rec["walker"]["analysis_s"],
                 top_ops=rec["walker"]["top_ops"][:4],
                 useful_flops_ratio=rec["useful_flops_ratio"],
                 predict_h100=pred.terms.to_dict(), wall_s=wall)
            if rec["n_devices"] != (512 if multi_pod else 256):
                fail(f"dryrun {arch} {shape}: {rec['n_devices']} devices")
            if shape.startswith("decode") and \
                    rec["memory"]["per_device_total"] >= DRYRUN_DEVICE_BYTES:
                fail(f"dryrun {arch} {shape}: "
                     f"{rec['memory']['per_device_total']} bytes a device")
    cfg = get_config("qwen2-7b")
    dryrun_card_check(
        torch, "qwen2-7b prefill 4x2048", cfg,
        ShapeConfig("prefill", SERVE_S, SERVE_B, "prefill"), SERVE_RUN,
        lambda d: (build_model(cfg, SERVE_RUN).init(
            torch.Generator(d).manual_seed(0), d),
            {"tokens": torch.randint(
                0, cfg.vocab_size, (SERVE_B, SERVE_S), device=d,
                generator=torch.Generator(d).manual_seed(1),
                dtype=torch.int32)}), dev)
    tcfg = dataclasses.replace(cfg, num_layers=TRAIN_LAYERS)

    def train_args(d):
        toks = torch.randint(0, tcfg.vocab_size, (1, TRAIN_SEQ + 1),
                             generator=torch.Generator(d).manual_seed(1),
                             device=d, dtype=torch.int32)
        return (init_train_state(build_model(tcfg, TRAIN_RUN),
                                 torch.Generator(d).manual_seed(0),
                                 device=d),
                {"tokens": toks[:, :-1].contiguous(),
                 "targets": toks[:, 1:].contiguous()})
    dryrun_card_check(
        torch, f"qwen2-7b train {TRAIN_LAYERS} layers 1x{TRAIN_SEQ}", tcfg,
        ShapeConfig("train", TRAIN_SEQ, 1, "train"), TRAIN_RUN, train_args,
        dev)
    close_fake_world()
    phase_s = time.perf_counter() - t_phase
    emit("dryrun", step="phase", seconds=phase_s, limit_s=DRYRUN_PHASE_S)
    if phase_s > DRYRUN_PHASE_S:
        fail(f"dryrun: the phase took {phase_s:.1f} s")


def phase_examples(torch) -> None:
    """Each ``examples/torch_*.py`` on the card (its default device) as a
    subprocess, in a scratch directory for the files it writes: exit 0,
    and its wall time."""
    names = sorted(f for f in os.listdir(os.path.join(ROOT, "examples"))
                   if f.startswith("torch_") and f.endswith(".py"))
    walls = {}
    with tempfile.TemporaryDirectory() as d:
        for name in names:
            t0 = time.perf_counter()
            out = subprocess.run(
                [sys.executable, os.path.join(ROOT, "examples", name)],
                cwd=d, env=src_env(), capture_output=True, text=True,
                timeout=EXAMPLE_TIMEOUT_S)
            walls[name] = time.perf_counter() - t0
            last = out.stdout.strip().splitlines()[-1:]
            emit("examples", example=name, rc=out.returncode,
                 wall_s=walls[name], last_line=last)
            if out.returncode != 0:
                fail(f"examples/{name} exited {out.returncode}: "
                     f"{out.stderr[-3000:]}")
    emit("examples", step="all", n=len(names), wall_s=sum(walls.values()))
    if len(names) != EXAMPLES_WANTED:
        fail(f"{len(names)} torch examples, want {EXAMPLES_WANTED}")


def _attn_grads(torch, fn, q, k, v, w):
    """fn(q, k, v)'s output, the gradients of sum(out * w), and the name of
    the output's backward node (which path the attention took)."""
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = fn(*leaves)
    return (out.detach(), torch.autograd.grad(out, leaves, w),
            type(out.grad_fn).__name__)


def _worst(torch, got, want, tol):
    """(max |got - want|, whether every element is within tol + tol|want|)."""
    err = (got.float() - want.float()).abs()
    return err.max().item(), bool((err <= tol + tol * want.float().abs())
                                  .all())


def tiny_step_errors(torch, dev, seed: int, batch_step: int,
                     tf32: bool = False) -> dict:
    """How far one train step of the tiny config on the card is from the
    same step on the CPU, from parameters drawn with ``seed`` and batch
    ``batch_step``: loss and gradient norm (relative), the moments (of each
    leaf's largest), and the card's parameters from AdamW's first step
    applied on the host to the card's own moments.  ``tf32`` lets the
    card's float32 matmuls run in TF32 (the planted fault); ``ok`` says
    whether every error is within its bound."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.configs.run import RunConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.model_zoo import build_model
    from repro_torch.models.params import map_tensors
    from repro_torch.optim.adamw import OptConfig, lr_at, tree_leaves
    from repro_torch.train.step import init_train_state, make_train_step
    tiny = ModelConfig(name="tiny-lm", family="dense", num_layers=2,
                       d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
                       d_ff=128, vocab_size=128, tie_embeddings=True)
    model = build_model(tiny, RunConfig(param_dtype="float32",
                                        compute_dtype="float32",
                                        remat="full", loss_chunk=16))
    opt = OptConfig(lr=1e-2, warmup_steps=10, decay_steps=2000,
                    weight_decay=0.0)
    step = make_train_step(model, opt)
    host = init_train_state(model, torch.Generator().manual_seed(seed),
                            device="cpu")
    p0 = map_tensors(host["params"], torch.clone)
    card = map_tensors(host, lambda t: t.to(dev, copy=True))
    batch = SyntheticLM(DataConfig(vocab_size=128, seq_len=64,
                                   global_batch=8, seed=3),
                        device="cpu").batch_at(batch_step)
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        card, m_card = step(card, map_tensors(batch, lambda t: t.to(dev)))
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    host, m_host = step(host, batch)

    def rel(k):
        return abs(m_card[k].item() / m_host[k].item() - 1)

    moments = update = 0.0
    lr = lr_at(opt, 0)
    for p, c_p, c_m, c_n, h_m, h_n in zip(*(tree_leaves(t) for t in (
            p0, card["params"], card["opt"]["mu"], card["opt"]["nu"],
            host["opt"]["mu"], host["opt"]["nu"]))):
        c_m, c_n = c_m.cpu(), c_n.cpu()
        for a, b in ((c_m, h_m), (c_n, h_n)):
            moments = max(moments, ((a - b).abs().max()
                                    / b.abs().max().clamp(min=1e-30)).item())
        upd = (c_m / (1 - opt.b1)) / ((c_n / (1 - opt.b2)).sqrt() + opt.eps)
        want = p - lr * (upd + opt.weight_decay * p)
        update = max(update, (c_p.cpu() - want).abs().max().item())
    errs = {"seed": seed, "batch": batch_step, "tf32": tf32,
            "loss_rel_err": rel("loss"),
            "grad_norm_rel_err": rel("grad_norm"), "moments_err": moments,
            "update_err": update}
    errs["ok"] = (errs["loss_rel_err"] <= TINY_STEP_TOL
                  and errs["grad_norm_rel_err"] <= TINY_STEP_TOL
                  and moments <= TINY_MOMENT_TOL
                  and update <= TINY_UPDATE_TOL)
    return errs


def phase_train(torch, np, calib):
    """The training path: blocked attention against dense attention at
    Qwen2-7B's heads, the tiny config's step on the card against the CPU,
    then Qwen2-7B's widths cut to 4 layers trained through make_job/train
    with a checkpoint, an injected failure and a restore, and
    the profile of two steady steps replayed on the kernel backend."""
    import dataclasses
    import statistics
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.configs.run import TRAIN_RUN
    from repro_torch.core import (H100_SXM, Emulator, ProfileStore,
                                  RuntimeProfiler, calibrate, predict)
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models.layers import attend_blocked, attend_full
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.runtime.supervisor import FailurePlan, SupervisorConfig
    from repro_torch.train.loop import make_job, train
    dev = torch.device("cuda")
    cfg = get_config("qwen2-7b")
    hq, hk, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    # -- blocked attention against dense attention on the card ------------
    def dense(window):
        def fn(q, k, v):
            pos = torch.arange(q.shape[1], device=dev)
            return attend_full(q, k, v, q_pos=pos, k_pos=pos, causal=True,
                               window=window, softcap=None)
        return fn

    def blocked(window):
        def fn(q, k, v):
            return attend_blocked(q, k, v, causal=True, window=window,
                                  softcap=None, block_q=ATTN_BLOCKS[0],
                                  block_kv=ATTN_BLOCKS[1])
        return fn

    def sdpa(window):
        def fn(q, k, v):
            S = q.shape[1]
            mask = None
            if window is not None:
                i = torch.arange(S, device=dev)
                d = i[:, None] - i[None, :]
                mask = (d >= 0) & (d < window)
            out = F.scaled_dot_product_attention(
                q.reshape(1, S, hq, hd).transpose(1, 2), k.transpose(1, 2),
                v.transpose(1, 2), attn_mask=mask, is_causal=mask is None,
                enable_gqa=True)
            return out.transpose(1, 2).reshape(q.shape)
        return fn

    cases = [(S, "float32", None) for S in TRAIN_ATTN_SEQS] + [
        (TRAIN_ATTN_SEQS[-1], "bfloat16", None),
        (TRAIN_ATTN_SEQS[-1], "float32", BANDED_WINDOW)]
    for S, dtype, window in cases:
        dt = getattr(torch, dtype)
        g = torch.Generator(dev).manual_seed(S)
        q, w = (torch.randn((1, S, hk, hq // hk, hd), generator=g,
                            device=dev).to(dt) for _ in range(2))
        k, v = (torch.randn((1, S, hk, hd), generator=g, device=dev).to(dt)
                for _ in range(2))
        out_b, g_b, path = _attn_grads(torch, blocked(window), q, k, v, w)
        out_d, g_d, _ = _attn_grads(torch, dense(window), q, k, v, w)
        row = {"S": S, "dtype": dtype, "window": window, "path": path}
        if path != ("BandedAttentionBackward" if window else
                    "BlockedFlashBackward"):
            fail(f"blocked attention took {path} at S {S}, window {window}")
        if dtype == "float32":
            fwd_err, fwd_ok = _worst(torch, out_b, out_d, ATTN_FWD_TOL)
            grad = [_worst(torch, a, b, ATTN_GRAD_TOL)
                    for a, b in zip(g_b, g_d)]
            row.update(max_abs_err_fwd=fwd_err, tol_fwd=ATTN_FWD_TOL,
                       max_abs_err_dq_dk_dv=[e for e, _ in grad],
                       tol_grad=ATTN_GRAD_TOL)
            ok = fwd_ok and all(o for _, o in grad)
        else:
            fwd_err, ok = _worst(torch, out_b, out_d, ATTN_BF16_TOL)
            row.update(max_abs_err_fwd=fwd_err, tol_fwd=ATTN_BF16_TOL)
        for name, fn in (("blocked", blocked(window)), ("dense", dense(window)),
                         ("sdpa", sdpa(window))):
            row[f"{name}_fwd_bwd_ms"] = event_ms(
                lambda: _attn_grads(torch, fn, q, k, v, w), reps=3,
                warmup=1)
        emit("train", step="attention", **row)
        if not ok:
            fail(f"blocked attention differs from dense attention: {row}")
        del q, k, v, w, out_b, out_d, g_b, g_d

    # -- the tiny config's step: the card against the CPU -----------------
    runs = [tiny_step_errors(torch, dev, seed, b, tf32)
            for tf32 in (False, True) for seed in TINY_SEEDS
            for b in TINY_BATCHES]
    f32 = [r for r in runs if not r["tf32"]]
    tf32 = [r for r in runs if r["tf32"]]
    keys = ("loss_rel_err", "grad_norm_rel_err", "moments_err", "update_err")
    emit("train", step="tiny_step_card_vs_cpu", seeds=list(TINY_SEEDS),
         batches=list(TINY_BATCHES), tol=TINY_STEP_TOL,
         tol_moments=TINY_MOMENT_TOL, tol_update=TINY_UPDATE_TOL,
         float32_worst={k: max(r[k] for r in f32) for k in keys},
         tf32_least_moments_err=min(r["moments_err"] for r in tf32),
         runs=runs)
    if not all(r["ok"] for r in f32):
        fail("the tiny train step on the card differs from the CPU's")
    if any(r["ok"] for r in tf32):
        fail("the tiny step's bounds pass a step with TF32 matmuls")

    # -- Qwen2-7B's widths cut to 4 layers: train, fail, restore ----------
    cut = dataclasses.replace(cfg, num_layers=TRAIN_LAYERS)
    run = TRAIN_RUN
    if not (run.attn_impl == "auto" and TRAIN_SEQ > run.blocked_threshold
            and run.remat == "full" and run.compute_dtype == "bfloat16"):
        fail(f"TRAIN_RUN is not the run this phase trains with: {run}")
    data = DataConfig(vocab_size=cut.vocab_size, seq_len=TRAIN_SEQ,
                      global_batch=1, seed=0)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as d:
        job = make_job(cut, run, opt=OptConfig(), data_cfg=data, ckpt_dir=d,
                       sup_cfg=SupervisorConfig(ckpt_every=TRAIN_CKPT_EVERY,
                                               keep=1),
                       device=dev)
        ck = job.ckpt
        spent = {"snapshot": [], "write": [], "restore": []}
        peaks = {"step": [], "restore": []}

        def timed(fn, name):
            def run_(*a, **kw):
                if name in peaks:     # not in the writer thread
                    torch.cuda.reset_peak_memory_stats()
                t = time.perf_counter()
                out_ = fn(*a, **kw)
                spent.setdefault(name, []).append(time.perf_counter() - t)
                if name in peaks:
                    peaks[name].append(torch.cuda.max_memory_allocated())
                return out_
            return run_

        for attr in ("_snapshot", "_write", "restore"):
            setattr(ck, attr, timed(getattr(ck, attr), attr.lstrip("_")))
        step_fn = job.step_fn
        job.step_fn = timed(step_fn, "step")
        t0 = time.perf_counter()
        out = train(job, TRAIN_STEPS, rng_seed=0, resume=False,
                    failure_plan=FailurePlan(
                        {TRAIN_FAIL_AT: "injected_node_loss"}))
        wall = time.perf_counter() - t0
        job.step_fn = step_fn
    rep = out["report"]
    losses = out["losses"]
    state = out["state"]
    del out
    # steady steps with no checkpoint written beside them: under the
    # supervisor the writer threads of the last save share the host's
    # cores with the loop that launches the step
    steady = []
    for s in range(3):
        batch = job.data.batch_at(TRAIN_STEPS + s)
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, met = job.step_fn(state, batch)
        met["loss"].item()
        steady.append(time.perf_counter() - t)
    step_s = statistics.median(steady)
    n_params = job.model.num_params()
    tokens = data.global_batch * TRAIN_SEQ
    # model flops: 6 per parameter and token for the matrix products (the
    # embedding table is a lookup, not one), causal attention's score and
    # value products (half the S x S square) forward and backward
    mm_params = n_params - cut.vocab_size * cut.d_model
    attn_flops = 6 * TRAIN_LAYERS * data.global_batch * TRAIN_SEQ ** 2 \
        * hq * hd
    model_flops = 6 * mm_params * tokens + attn_flops
    emit("train", step="train", model="qwen2-7b", layers=TRAIN_LAYERS,
         params=n_params, batch=data.global_batch, seq=TRAIN_SEQ,
         steps_run=rep.steps_run, restarts=rep.restarts,
         restored_from=rep.restored_from, failures=rep.failures,
         losses=losses, step_times_under_ckpt_s=rep.step_times,
         steady_step_times_s=steady, step_ms=step_s * 1e3,
         tokens_per_s=tokens / step_s,
         max_memory_allocated=max(peaks["step"] + peaks["restore"]),
         step_peaks=peaks["step"], restore_peaks=peaks["restore"],
         model_flops_per_step=model_flops,
         bf16_peak_share=model_flops / step_s / PEAK_BF16_FLOPS,
         ckpt_bytes=sum(t.numel() * t.element_size()
                        for t in _leaves(state)),
         ckpt_snapshot_s=spent["snapshot"], ckpt_write_s=spent["write"],
         ckpt_restore_s=spent["restore"], wall_s=wall)
    if rep.restarts != 1 or rep.restored_from != [TRAIN_FAIL_AT]:
        fail(f"the run did not restart once from step {TRAIN_FAIL_AT}: "
             f"{rep.restarts} restarts from {rep.restored_from}")
    if len(losses) != TRAIN_STEPS or not all(math.isfinite(x)
                                             for x in losses):
        fail(f"losses of the run: {losses}")
    if len(spent["restore"]) != 1 or len(spent["write"]) != \
            TRAIN_STEPS // TRAIN_CKPT_EVERY:
        fail(f"checkpoints written {len(spent['write'])} times, restored "
             f"{len(spent['restore'])}")

    # where a step's device time goes (the step launches none of the
    # port's counted kernels, so any trace holds every counted launch)
    zero_counters()
    batch = job.data.batch_at(TRAIN_STEPS + 3)
    twall, busy, top = device_time(torch, lambda: job.step_fn(state, batch))
    if any(counters().values()):
        fail(f"a train step launched counted kernels: {counters()}")
    emit("train", step="trace_step", wall_s=twall, kernel_s=busy,
         busy_share=busy / twall, top_kernels=top[:6])

    # -- the profile of two steady steps, replayed on the kernel backend --
    hostcal = calibrate(device="cpu")

    def two_steps():
        nonlocal state
        for s in (TRAIN_STEPS + 4, TRAIN_STEPS + 5):
            state, met = job.step_fn(state, job.data.batch_at(s))
            met["loss"].item()

    prof = RuntimeProfiler(sample_rate=20).profile_callable(
        two_steps, command="train-qwen2-7b", tags={
            "layers": str(TRAIN_LAYERS), "seq": str(TRAIN_SEQ)},
        flops_per_cpu_s=hostcal.flops_per_s)
    del state
    with tempfile.TemporaryDirectory() as d:
        store = ProfileStore(d)
        store.add(prof)
        loaded = store.latest(prof.command, prof.tags)
    if loaded is None or loaded.totals != prof.totals:
        fail("the train profile did not round-trip through the store")
    em = Emulator(calib=calib, backend="cuda")
    want = planned_counts(em, loaded)
    zero_counters()
    rep = em.emulate(loaded)
    torch.cuda.synchronize()
    got = counters()
    emit("train", step="replay", backend="cuda", mode=rep.mode,
         n_samples=rep.n_samples, n_dispatches=rep.n_dispatches,
         ttc_s=rep.ttc_s, profiled_wall_s=prof.meta["wall_s"],
         predicted_ttc_s=predict(loaded, H100_SXM).ttc_max,
         flops=loaded.totals.flops, counters=got)
    if not same_amounts(rep.consumed, loaded.totals):
        fail(f"train replay consumed {rep.consumed} != {loaded.totals}")
    if got != want or rep.mode != "fused" or not got["segment"]:
        fail(f"train replay ({rep.mode}) counted {got}, want {want}")


def family_batch(torch, np, cfg, dtype, B: int, S: int, dev, seed: int,
                 src: int = 0):
    """A prefill batch of ``B`` x ``S`` for ``cfg``: tokens; vision embeds
    with their M-RoPE positions (the first half of the positions a square
    vision grid); ``src`` audio frames and ``S`` target tokens (the
    encoder-decoder)."""
    from repro_torch.models import frontends
    gen = torch.Generator(dev).manual_seed(seed)
    rng = np.random.default_rng(seed)
    if cfg.family == "encdec":
        return {"src_embeds": frontends.audio_frame_embeddings(
                    gen, B, src, cfg.d_model, dtype, dev),
                "tgt_tokens": torch.from_numpy(rng.integers(
                    0, cfg.vocab_size, (B, S)).astype(np.int32)).to(dev)}
    if cfg.family == "vlm":
        side = int(math.isqrt(S // 2))
        return {"embeds": frontends.vision_patch_embeddings(
                    gen, B, S, cfg.d_model, dtype, dev),
                "positions": frontends.mrope_positions(
                    B, S, grid=(1, side, side), device=dev)}
    return {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)).to(dev)}


def greedy_steps(model, params, batch, steps: int, max_len: int,
                 src_len=None):
    """The prefill and ``steps`` greedy decode steps: ([B, steps + 1]
    tokens as lists, the prefill's final hidden states)."""
    import torch
    from repro_torch.serve.step import greedy_token, make_decode_step
    decode = make_decode_step(model)
    leaf = next(v for k, v in batch.items() if k != "positions")
    B = leaf.shape[0]
    if model.cfg.family == "encdec":
        cache = model.init_cache(B, max_len, src_len=src_len,
                                 device=leaf.device)
    else:
        cache = model.init_cache(B, max_len, device=leaf.device)
    hidden, cache, _ = model.forward(params, batch, cache=cache)
    tok = greedy_token(model, params, hidden[:, -1:])
    out = [tok]
    for _ in range(steps):
        tok, cache = decode(params, tok, cache)
        out.append(tok)
    return torch.cat(out, dim=1).tolist(), hidden


def family_depth_cut(torch, np, cfg, dev) -> None:
    """``cfg``'s widths cut in depth, float32: the flash kernel against
    dense attention (final hidden states, greedy tokens of the prefill and
    CUT_DECODE_STEPS decode steps)."""
    import dataclasses
    from repro_torch.configs.run import RunConfig
    from repro_torch.models.model_zoo import build_model
    layers = CUT_LAYERS.get(cfg.family, 2)
    cut = dataclasses.replace(cfg, num_layers=layers)
    S = CUT_LONG_S if cfg.family == "hybrid" else CUT_S
    src = 0
    if cfg.family == "encdec":           # S frames, S / 2 target tokens
        S, src = S // 2, S
    batch = family_batch(torch, np, cut, torch.float32, CUT_B, S, dev,
                         seed=1, src=src)
    f32 = dict(param_dtype="float32", compute_dtype="float32",
               cache_dtype="float32")
    params, models, hidden, tokens = None, {}, {}, {}
    with torch.inference_mode():
        for impl in ("full", "cuda"):
            model = models[impl] = build_model(
                cut, RunConfig(attn_impl=impl, **f32))
            if params is None:
                params = model.init(torch.Generator(dev).manual_seed(0), dev)
            tokens[impl], hidden[impl] = greedy_steps(
                model, params, batch, CUT_DECODE_STEPS,
                S + CUT_DECODE_STEPS, src_len=src)
        checked = {"final_hidden": (hidden["cuda"], hidden["full"])}
        extra = {}
        if cfg.family == "encdec":
            checked, extra = encdec_cut_parts(torch, params, batch, models)
    errs, ok = {}, True
    for name, (got, want) in checked.items():
        diff = (got - want).abs()
        err = diff.max().item()
        scale = max(1.0, want.abs().max().item())
        errs[name] = {"max_abs_err": err, "max_abs": scale,
                      "elements_above_tol": int((diff > DEPTH_CUT_TOL).sum()
                                                .item())}
        ok = ok and bool(torch.isfinite(got).all()) \
            and err <= DEPTH_CUT_TOL * scale
    emit("families", step="depth_cut_f32", model=cfg.name, layers=layers,
         batch=CUT_B, prompt=S, frames=src, tol_of_max=DEPTH_CUT_TOL,
         **errs, **extra, tokens_identical=tokens["cuda"] == tokens["full"],
         tokens=tokens["cuda"])
    if not ok:
        fail(f"{cfg.name} depth cut: 'cuda' and 'full' differ: {errs} "
             f"(tolerance {DEPTH_CUT_TOL} of the largest magnitude)")
    if tokens["cuda"] != tokens["full"]:
        fail(f"{cfg.name} depth cut: greedy tokens differ: {tokens}")
    if cfg.family == "ssm":
        mamba_checks(torch, np, model, params, dev)


def encdec_cut_parts(torch, params, batch, models):
    """The encoder-decoder's float32 cut, flash against dense attention at
    its two uses apart: the encoders' outputs (unmasked self-attention)
    and the first decoder layer's causal self-attention on the embedded
    target tokens.  Its decoder's cross-attention is saturated at the cut's
    weights (logits' std ~512), so a difference at the float32 floor
    upstream flips the argmax key of some queries: the decoders' final
    hidden states, over one encoding and end to end, are printed, not
    held."""
    import torch.nn.functional as F
    from repro_torch.models import encdec
    from repro_torch.models.layers import attention, rmsnorm
    from repro_torch.models.params import map_tensors
    from repro_torch.models.transformer import _attn_run
    enc = {impl: encdec.encode(params, batch["src_embeds"], cfg=m.cfg,
                               run=m.run) for impl, m in models.items()}
    cfg = models["full"].cfg
    tgt = batch["tgt_tokens"]
    x = encdec._embed_scale(F.embedding(tgt.long(), params["embed"]), cfg,
                            models["full"].run)
    pl = map_tensors(params["dec_layers"], lambda p: p[0])
    h = rmsnorm(pl["ln_self"], x, cfg.norm_eps)
    pos = torch.arange(tgt.shape[1], device=tgt.device)[None].expand(
        tgt.shape)
    self_attn = {impl: attention(pl["self_attn"], h, cfg=cfg, positions=pos,
                                 run=_attn_run(m.run))[0]
                 for impl, m in models.items()}
    encode, dec = encdec.encode, {}
    encdec.encode = lambda *args, **kw: enc["full"]
    try:
        for impl, m in models.items():
            dec[impl] = m.forward(params, batch)[0]
    finally:
        encdec.encode = encode
    e2e = (models["cuda"].forward(params, batch)[0]
           - models["full"].forward(params, batch)[0]).abs().max()
    return ({"encoder": (enc["cuda"], enc["full"]),
             "decoder_self_attention": (self_attn["cuda"],
                                        self_attn["full"])},
            {"decoder_on_one_encoding_max_abs_err":
                (dec["cuda"] - dec["full"]).abs().max().item(),
             "end_to_end_max_abs_err": e2e.item()})


def mamba_checks(torch, np, model, params, dev) -> None:
    """Mamba-2 on the card: the chunked SSD scan against its recurrent
    oracle at Mamba-2-780M's heads, and the float32 cut's prefill then
    decode steps against one forward over the same tokens."""
    import torch.nn.functional as F
    from repro_torch.models import ssm
    cfg = model.cfg
    s = cfg.ssm
    g = torch.Generator(dev).manual_seed(3)
    H, P, N = cfg.ssm_heads, s.head_dim, s.state_dim
    x = torch.randn((1, SSD_SEQ, H, P), generator=g, device=dev)
    dt = F.softplus(torch.randn((1, SSD_SEQ, H), generator=g, device=dev))
    A = -torch.exp(0.5 * torch.randn((H,), generator=g, device=dev))
    Bm = torch.randn((1, SSD_SEQ, s.ngroups, N), generator=g, device=dev)
    Cm = torch.randn((1, SSD_SEQ, s.ngroups, N), generator=g, device=dev)
    with torch.inference_mode():
        t0 = time.perf_counter()
        y, st = ssm.ssd_chunked(x, dt, A, Bm, Cm, chunk=s.chunk_size,
                                return_state=True)
        torch.cuda.synchronize()
        chunked_first_call_s = time.perf_counter() - t0
        ry, rs = ssm.ssd_reference(x, dt, A, Bm, Cm)
    errs = {}
    for name, got, want in (("y", y, ry), ("final_state", st, rs)):
        d = (got - want).abs()
        errs[name] = {"max_abs_err": d.max().item(),
                      "max_abs": want.abs().max().item(),
                      "elementwise_1e-4_share": (
                          d <= 1e-4 + 1e-4 * want.abs()).float().mean()
                      .item()}
    ok = all(e["max_abs_err"] <= SSD_TOL * e["max_abs"]
             for e in errs.values())
    emit("families", step="ssd_scan_vs_oracle", heads=H, head_dim=P,
         state_dim=N, groups=s.ngroups, seq=SSD_SEQ, chunk=s.chunk_size,
         tol_of_max=SSD_TOL, chunked_first_call_s=chunked_first_call_s,
         **errs)
    if not (ok and H == SSD_HEADS):
        fail(f"the SSD scan differs from its oracle: {errs}")

    # prefill of MAMBA_PREFIX tokens then MAMBA_DECODE steps, each step's
    # logits against the forward over all of them
    rng = np.random.default_rng(4)
    n = MAMBA_PREFIX + MAMBA_DECODE
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (CUT_B, n))
                            .astype(np.int32)).to(dev)
    worst = 0.0
    with torch.inference_mode():
        full = model.logits(params, model.forward(params,
                                                  {"tokens": toks})[0])
        cache = model.init_cache(CUT_B, n, device=dev)
        _, cache, _ = model.forward(
            params, {"tokens": toks[:, :MAMBA_PREFIX]}, cache=cache)
        for t in range(MAMBA_PREFIX, n):
            h, cache, _ = model.forward(params, {"tokens": toks[:, t:t + 1]},
                                        cache=cache, decode=True)
            got, want = model.logits(params, h)[:, 0], full[:, t]
            worst = max(worst, ((got - want).abs() / (
                MAMBA_DECODE_TOL + MAMBA_DECODE_TOL * want.abs())).max()
                .item())
    emit("families", step="mamba_decode_vs_forward", prefix=MAMBA_PREFIX,
         decode_steps=MAMBA_DECODE, worst_err_over_bound=worst,
         tol=MAMBA_DECODE_TOL)
    if not worst <= 1.0:
        fail(f"Mamba-2 decode differs from its forward: {worst} x the "
             f"bound of {MAMBA_DECODE_TOL}")


def family_flash_shapes(cfg, kind: str):
    """The flash calls of ``cfg``'s prefill in FAMILY_RUNS' traffic:
    (BH, BKV, S, hd, causal, window), one a distinct shape."""
    if cfg.family == "ssm":
        return []
    B, Hq, Hk, hd = SERVE_B, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if kind == "encdec":
        return [(B * Hq, B * Hk, ENCDEC_SRC, hd, False, None),
                (B * Hq, B * Hk, ENCDEC_TGT, hd, True, None)]
    S = max(LONG_PROMPTS) if kind == "engine_long" else max(SERVE_PROMPTS)
    shapes = [(B * Hq, B * Hk, S, hd, True, None)]
    if cfg.attn.sliding_window is not None:
        shapes.append((B * Hq, B * Hk, S, hd, True, cfg.attn.sliding_window))
    return shapes


def check_family_flash(torch, cfg, kind, dev) -> None:
    """The bf16 flash kernel against its plain version at ``cfg``'s prefill
    shapes, on random inputs: FLASH_TOL and the error's RMS within
    FLASH_SERVE_REL_RMS of the output's, as at the serving shape.  These
    launches are a comparison's, not the path's: the caller counts the
    path's."""
    from repro_torch.kernels.flash_attention import kernel as fk, ref as fref
    g = torch.Generator(dev).manual_seed(6)
    tol = FLASH_TOL["bfloat16"]
    for BH, BKV, S, hd, causal, window in family_flash_shapes(cfg, kind):
        q, k, v = (torch.randn((n, S, hd), generator=g, device=dev).to(
            torch.bfloat16) for n in (BH, BKV, BKV))
        kw = dict(causal=causal, window=window, group=BH // BKV)
        got = fk.flash_attention(q, k, v, block_q=512, block_kv=1024,
                                 **kw).float()
        want = fref.flash_attention(q, k, v, **kw).float()
        err = (got - want).abs().max().item()
        rel_rms = ((got - want).square().mean().sqrt()
                   / want.square().mean().sqrt()).item()
        ok = torch.allclose(got, want, atol=tol, rtol=tol) and \
            rel_rms < FLASH_SERVE_REL_RMS
        emit("families", step="flash_vs_plain", model=cfg.name,
             dtype="torch.bfloat16", case=[BH, BKV, S, hd, causal, window],
             max_abs_err=err, tol=tol, rel_rms_err=rel_rms, ok=ok)
        if not ok:
            fail(f"{cfg.name}: flash_attention at "
                 f"{[BH, BKV, S, hd, causal, window]}: max abs err {err}, "
                 f"error RMS / output RMS {rel_rms}")
        del q, k, v, got, want


def flash_layers(cfg) -> int:
    """Layers whose prefill attention routes to the flash kernel under
    attn_impl="cuda": every attention layer (the encoder's and the
    decoder's self-attention; the cross-attention never does)."""
    if cfg.family == "ssm":
        return 0
    return cfg.num_layers + cfg.num_encoder_layers


def family_serve(torch, np, cfg, kind, dev, host, calib):
    """``cfg`` in bf16 on the card: its traffic under the RuntimeProfiler,
    a trace, and the profile replayed on the kernel backend.  Returns the
    flash launches of the profiled run."""
    import dataclasses
    from repro_torch.configs.run import SERVE_RUN
    from repro_torch.core import Emulator, RuntimeProfiler
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.models import moe as moe_lib
    from repro_torch.models.model_zoo import build_model
    from repro_torch.serve.engine import Engine, Request
    from repro_torch.serve.step import make_decode_step, make_prefill_step
    model = build_model(cfg, dataclasses.replace(SERVE_RUN,
                                                 attn_impl="cuda"))
    t0 = time.perf_counter()
    params = model.init(torch.Generator(dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    emit("families", step="init", model=cfg.name, layers=cfg.num_layers,
         seconds=time.perf_counter() - t0, params=model.num_params(),
         param_bytes=sum(t.numel() * t.element_size()
                         for t in _leaves(params)))
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

    rng = np.random.default_rng(2)
    if kind.startswith("engine"):
        plens = LONG_PROMPTS if kind == "engine_long" else SERVE_PROMPTS
        engine = Engine(model, params, batch_slots=SERVE_B,
                        max_len=max(plens) + SERVE_NEW_TOKENS, device=dev)
        prompts = [list(rng.integers(0, cfg.vocab_size, n)) for n in plens]
        prefill, decode = engine.prefill, engine.decode

        def traffic(new_tokens):
            reqs = engine.serve([Request(prompt=p, max_new_tokens=new_tokens)
                                 for p in prompts])
            return [r.out_tokens for r in reqs]

        def set_steps(p, d):
            engine.prefill, engine.decode = p, d
        waves, new_tokens = -(-len(prompts) // SERVE_B), SERVE_NEW_TOKENS
        batch = {"tokens": torch.zeros((SERVE_B, max(plens)),
                                       dtype=torch.int32, device=dev)}
        for i, p in enumerate(prompts):
            batch["tokens"][i, -len(p):] = torch.tensor(p, dtype=torch.int32)
    else:
        if kind == "encdec":
            S, src = ENCDEC_TGT, ENCDEC_SRC
        else:
            S, src = 2 * VISION_GRID[1] * VISION_GRID[2], 0
        batch = family_batch(torch, np, cfg, torch.bfloat16, SERVE_B, S,
                             dev, seed=2, src=src)
        steps = {"prefill": make_prefill_step(
                     model, S + FAMILY_DECODE_STEPS, src_len=src or None),
                 "decode": make_decode_step(model)}
        prefill, decode = steps["prefill"], steps["decode"]

        def traffic(n_steps):
            with torch.inference_mode():
                tok, cache = steps["prefill"](params, batch)
                out = [tok]
                for _ in range(n_steps):
                    tok, cache = steps["decode"](params, tok, cache)
                    out.append(tok)
            return torch.cat(out, dim=1).tolist()

        def set_steps(p, d):
            steps["prefill"], steps["decode"] = p, d
        waves, new_tokens = 1, FAMILY_DECODE_STEPS

    traffic(2)                  # warm up: cuBLAS picks its kernels
    set_steps(timed(prefill, "prefill"), timed(decode, "decode"))
    drops = []                  # each MoE layer's drop fraction, in order
    moe_block = moe_lib.moe_block

    def recording(p, x, *, cfg):
        out, aux = moe_block(p, x, cfg=cfg)
        drops.append(aux["moe_drop_fraction"])
        return out, aux
    moe_lib.moe_block = recording
    torch.cuda.reset_peak_memory_stats()
    fk.launches = 0
    out = {}
    try:
        prof = RuntimeProfiler(sample_rate=20).profile_callable(
            lambda: out.setdefault("tokens", traffic(new_tokens)),
            command=f"serve-{cfg.name}", tags={"batch": str(SERVE_B),
                                               "traffic": kind},
            flops_per_cpu_s=host.flops_per_s)
    finally:
        moe_lib.moe_block = moe_block
    launches = fk.launches
    peak = torch.cuda.max_memory_allocated()
    tokens = out["tokens"]
    generated = sum(len(t) for t in tokens)
    serve_s = sum(times["prefill"]) + sum(times["decode"])
    want_launches = flash_layers(cfg) * waves
    moe = {}
    if drops:
        per_call = cfg.num_layers
        fr = torch.stack(drops).float().cpu()
        moe = {"moe_drop_fraction_prefill": fr[:per_call].mean().item(),
               "moe_drop_fraction_decode": fr[per_call:].mean().item(),
               "moe_layers_recorded": len(drops)}
    emit("families", step="serve", model=cfg.name, family=cfg.family,
         layers=cfg.num_layers, traffic=kind, requests=len(tokens),
         waves=waves, prefill_ms=sum(times["prefill"]) * 1e3 / waves,
         decode_ms_per_step=sum(times["decode"]) * 1e3 / max(
             1, len(times["decode"])),
         decode_steps=len(times["decode"]), generated_tokens=generated,
         tokens_per_s=generated / serve_s, wall_s=prof.meta["wall_s"],
         max_memory_allocated=peak, flash_launches=launches,
         flash_launches_want=want_launches, **moe,
         tokens=[t[:4] for t in tokens])
    if launches != want_launches:
        fail(f"{cfg.name}: flash_attention launched {launches} times, want "
             f"{flash_layers(cfg)} attention layers x {waves} waves")
    if any(len(t) != new_tokens + (kind in ("vision", "encdec"))
           or not all(0 <= v < cfg.vocab_size for v in t) for t in tokens):
        fail(f"{cfg.name}: tokens {tokens}")
    if moe and not 0.0 <= moe["moe_drop_fraction_prefill"] < 1.0:
        fail(f"{cfg.name}: drop fraction {moe}")

    # a prefill and 4 decode steps under the profiler: the trace must hold
    # every flash launch the wrapper counted (PERF.md, open questions)
    def prefill_and_decode():
        with torch.inference_mode():
            tok, cache = prefill(params, batch)
            for _ in range(4):
                tok, cache = decode(params, tok, cache)

    for attempt in range(1, TRACE_ATTEMPTS + 1):
        fk.launches = 0
        wall, busy, top = device_time(torch, prefill_and_decode)
        traced = sum(k[2] for k in top if BF16_FLASH_SYMBOL in k[0])
        emit("families", step="trace_prefill_decode_4", model=cfg.name,
             attempt=attempt, wall_s=wall, kernel_s=busy,
             busy_share=busy / wall, top_kernels=top[:5],
             traced_flash=traced, counted_flash=fk.launches)
        if traced == fk.launches:
            break
    else:
        fail(f"{cfg.name}: {TRACE_ATTEMPTS} traces missed flash launches")

    # the profile replayed on the kernel backend (in memory: the phase
    # writes nothing to disk)
    em = Emulator(calib=calib, backend="cuda")
    want = planned_counts(em, prof)
    zero_counters()
    rep = em.emulate(prof)
    torch.cuda.synchronize()
    got = counters()
    emit("families", step="replay", model=cfg.name, backend="cuda",
         mode=rep.mode, n_samples=rep.n_samples,
         n_dispatches=rep.n_dispatches, ttc_s=rep.ttc_s,
         profiled_wall_s=prof.meta["wall_s"], flops=prof.totals.flops,
         counters=got)
    if not same_amounts(rep.consumed, prof.totals):
        fail(f"{cfg.name} replay consumed {rep.consumed} != {prof.totals}")
    if got != want or rep.mode != "fused" or not got["segment"]:
        fail(f"{cfg.name} replay ({rep.mode}) counted {got}, want {want}")
    return launches


def moe_train_step(torch, np, dev) -> None:
    """One training step of Moonlight-16B-A3B's widths cut to
    MOE_TRAIN_LAYERS layers, under TRAIN_RUN (f32 master weights, bf16
    compute, remat), after one step that warms up: finite loss and aux
    terms, step time, peak memory."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.configs.run import TRAIN_RUN
    from repro_torch.models.model_zoo import build_model
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train.step import init_train_state, make_train_step
    cfg = dataclasses.replace(get_config("moonshot-v1-16b-a3b"),
                              num_layers=MOE_TRAIN_LAYERS)
    model = build_model(cfg, TRAIN_RUN)
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(model, torch.Generator(dev).manual_seed(0),
                             device=dev)
    state_bytes = sum(t.numel() * t.element_size() for t in _leaves(state))
    step = make_train_step(model, OptConfig())
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (1, MOE_TRAIN_SEQ + 1)).astype(np.int64)).to(dev)
    batch = {"tokens": toks[:, :-1].int(), "targets": toks[:, 1:].int()}
    step_s, mets = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, met = step(state, batch)
        met = {k: v.item() for k, v in met.items()}
        step_s.append(time.perf_counter() - t)
        mets.append(met)
    emit("families", step="moe_train_step", model=cfg.name,
         layers=MOE_TRAIN_LAYERS, params=model.num_params(),
         state_bytes=state_bytes, seq=MOE_TRAIN_SEQ, step_s=step_s,
         step_ms=step_s[-1] * 1e3,
         tokens_per_s=MOE_TRAIN_SEQ / step_s[-1],
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         metrics=mets[-1])
    for met in mets:
        for k in ("loss", "moe_load_balance", "moe_router_z",
                  "moe_drop_fraction", "grad_norm"):
            if not math.isfinite(met[k]):
                fail(f"MoE train step: {k} = {met[k]}")


def phase_families(torch, np, rows, calib, host, dev=None):
    """The other model families at their published widths (FAMILY_RUNS):
    a float32 depth cut of each against dense attention, each served in
    bf16 under the RuntimeProfiler with its profile replayed on the kernel
    backend, Mamba-2's scan against its oracle, one MoE training step.
    ``host``: the host's calibration (flops per CPU second) the serve
    phase measured."""
    import dataclasses
    import gc
    from repro_torch.configs import get_config
    dev = torch.device("cuda") if dev is None else dev
    launches = 0
    for name, layers, kind in FAMILY_RUNS:
        cfg = get_config(name)
        family_depth_cut(torch, np, cfg, dev)
        check_family_flash(torch, cfg, kind, dev)
        gc.collect()
        torch.cuda.empty_cache()
        if layers is not None:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        launches += family_serve(torch, np, cfg, kind, dev, host, calib)
        gc.collect()
        torch.cuda.empty_cache()
    moe_train_step(torch, np, dev)
    gc.collect()
    torch.cuda.empty_cache()
    rows["flash_attention"]["launches"] += launches
    rows["flash_attention"]["families_launches"] = launches


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
    build_info = phase_build()
    rows = phase_kernels(torch, np, build_info)
    calib, per_iter_ms = phase_main_path(torch, rows)
    rows.update(phase_collective(torch, np, calib, build_info))
    fleet_profiles, fleet_refs = phase_fleet(torch, calib, per_iter_ms)
    phase_service(torch, calib, fleet_profiles, fleet_refs)
    host, served = phase_serve(torch, np, rows)
    phase_static(torch, np, calib, served)
    phase_dryrun(torch)
    phase_train(torch, np, calib)
    phase_families(torch, np, rows, calib, host)
    phase_examples(torch)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    for row in rows.values():
        missing = [k for k in keys if k not in row]
        if missing:
            fail(f"{row['name']}: kernels line lacks {missing}")
        if not row["launches"]:
            fail(f"{row['name']}: the main path launched it no time")
    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

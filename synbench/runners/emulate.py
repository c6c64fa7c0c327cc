"""Requests emulated back to back: each request is the static profile of
its prefill (batch 1) followed by its decode steps, replayed through
``Emulator.emulate`` on the ``"cuda"`` backend, one segment launch a
request.  Closed loop, one client; the window closes at the first cycle's
end after ``--seconds`` (every seed then emulates whole cycles, the same
requests in another order).

Set-up profiles each distinct prefill and decode shape of the mix on meta
tensors (``profile_step``, granularity ``"scan"``) and builds every
distinct request's profile, so the window does nothing but emulate.  The
benchmark times its own spans around each request and each segment run.

The checks, after the window, against ``reference.emulation`` and the
configuration's analytic count: the profiles' product operations and
per-sample bytes; every call's iteration table and consumed amounts; the
kernel's device-counted iterations, passes and launches; each launch's
burn carry and the whole ring at the end.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List

import numpy as np

from synbench.core import peaks, traffic
from synbench.core.harness import Check, log
from synbench.core.spans import Spans
from synbench.reference import emulation as emu_ref

#: what this runner calls on the configuration's reference module
#: (``reference/<name>.py``)
REFERENCE_NEEDS = ("port_fields", "DECODE_COST_DEPENDS_ON_LENGTH",
                   "prefill_samples", "decode_samples")


class Runner:
    def __init__(self, cell, ref, device, seed: int, rehearse: bool):
        self.cell, self.ref, self.device = cell, ref, device
        self.seed, self.rehearse = seed, rehearse
        self.mix = cell.mix
        self.tile = int(self.mix["tile"])
        self.block = int(self.mix["block_bytes"])
        self.records: List[tuple] = []         # (request, t0, t1, report)
        self.calls: List[dict] = []             # every emulate call
        self.attempted = self.failed = 0
        self.window_s = 0.0
        self.t0_ns = self.t1_ns = 0
        self._spans = Spans()

    # -- set-up ---------------------------------------------------------------

    def _profiles(self):
        import torch
        from repro_torch.configs.run import SERVE_RUN
        from repro_torch.core import profile_step
        from repro_torch.models.model_zoo import build_model
        from repro_torch.serve.step import make_decode_step, make_prefill_step
        from synbench.runners.common import port_config

        cfg = port_config(self.cell, self.ref, self.rehearse)
        run = dataclasses.replace(SERVE_RUN,
                                  attn_impl=self.mix["profile_attention"])
        model = build_model(cfg, run)
        params = model.abstract()
        meta = torch.device("meta")
        sizes = self.cell.sizes
        decode_step = make_decode_step(model)
        prefills, decodes = {}, {}
        by_len = self.ref.DECODE_COST_DEPENDS_ON_LENGTH
        # (profile, its counter's cost, the analytic count), held to each
        # other after the window
        self._profiled = []

        for P, O in traffic.shapes(self.mix):
            T = P + O
            if P not in prefills:
                step = make_prefill_step(model, T)

                def fn(p, b, step=step):
                    with torch.inference_mode():
                        return step(p, b)
                batch = {"tokens": torch.zeros((1, P), dtype=torch.int32,
                                               device=meta)}
                prof, cost = profile_step(fn, params, batch,
                                          command="prefill", device="meta")
                self._profiled.append(
                    (prof, cost, self.ref.prefill_samples(sizes, 1, P)))
                prefills[P] = prof
            key = T if by_len else 0
            if O > 1 and key not in decodes:
                def dfn(p, t, c):
                    with torch.inference_mode():
                        return decode_step(p, t, c)
                cache = model.init_cache(1, T, device=meta)
                tok = torch.zeros((1, 1), dtype=torch.int32, device=meta)
                prof, cost = profile_step(dfn, params, tok, cache,
                                          command="decode", device="meta")
                self._profiled.append(
                    (prof, cost, self.ref.decode_samples(sizes, 1, T)))
                decodes[key] = prof
        return prefills, decodes, by_len

    def setup(self) -> None:
        from repro_torch.core import Emulator
        from repro_torch.core import emulator as emu_mod
        from repro_torch.core.calibrate import HostCalibration
        from repro_torch.core.metrics import SynapseProfile
        from repro_torch.kernels.segment import kernel as seg_kernel
        from repro_torch.kernels.segment import ops as seg_ops

        t = time.perf_counter()
        prefills, decodes, by_len = self._profiles()
        log(f"profiled {len(prefills)} prefill and {len(decodes)} decode "
            f"shapes on meta tensors in {time.perf_counter() - t:.3f} s")
        self.profiles = {}
        for P, O in traffic.shapes(self.mix):
            dec = decodes.get(P + O if by_len else 0)
            samples = list(prefills[P].samples)
            if O > 1:
                # the decode steps share their Sample objects: the replay
                # reads their resources and order, not their index
                samples += dec.samples * (O - 1)
            self.profiles[(P, O)] = SynapseProfile(
                command=f"{self.cell.workload['config']}-request",
                tags={"prompt": str(P), "output": str(O)}, samples=samples)
        self._runs_of: Dict[tuple, list] = {}

        self.seg_kernel = seg_kernel
        # spans around the program's calls, and the outputs they return
        launched: List = []
        compiled: List = []
        orig_compile = emu_mod.compile_schedule
        orig_segment = seg_ops.segment

        def compile_schedule(*a, **k):
            sched = orig_compile(*a, **k)
            compiled.append(sched)
            return sched

        def segment(*a, **k):
            run = orig_segment(*a, **k)
            launched.append(run)
            return run

        emu_mod.compile_schedule = compile_schedule
        seg_ops.segment = segment
        self._restore = ((emu_mod, "compile_schedule", orig_compile),
                         (seg_ops, "segment", orig_segment))
        self._compiled, self._launched = compiled, launched

        self.em = Emulator(calib=HostCalibration(1.0, 1.0, 1.0, 1.0),
                           backend="cuda", compute_tile=self.tile,
                           mem_block=self.block, device=self.device)
        seg_run = self.em._segments.run

        def timed_run(segment_):
            with self._spans.span("segment.run"):
                return seg_run(segment_)
        self.em._segments.run = timed_run
        # warm-up: the ring made and filled, the kernel library built or
        # loaded, the first cooperative launch taken
        first = min(self.profiles, key=lambda k: (k[1], k[0]))
        t = time.perf_counter()
        self._emulate(first, window=False)
        log(f"warm-up request {first} in {time.perf_counter() - t:.3f} s")

    def _emulate(self, key, window: bool):
        rep = self.em.emulate(self.profiles[key])
        self.calls.append({"key": key, "report": rep, "window": window,
                           "schedules": list(self._compiled),
                           "launched": list(self._launched)})
        self._compiled.clear()
        self._launched.clear()
        return rep

    def _runs(self, key) -> list:
        """The reference's runs of a request's profile (worked out after
        the window, once a profile)."""
        if key not in self._runs_of:
            self._runs_of[key] = emu_ref.runs(self.profiles[key].samples)
        return self._runs_of[key]

    def _profile_checks(self) -> List[Check]:
        """Each profile against the analytic count: the relative gap of
        its product operations, and of each sample's bytes."""
        worst = {"profile_dot_flops": 0.0, "profile_bytes": 0.0,
                 "profile_samples": 0.0}
        for prof, cost, want in self._profiled:
            f_want = sum(w[0] for w in want)
            worst["profile_dot_flops"] = max(
                worst["profile_dot_flops"],
                abs(cost.dot_flops - f_want) / f_want)
            got = [s.resources.hbm_bytes for s in prof.samples]
            if len(got) != len(want):
                worst["profile_samples"] += 1
                continue
            for g, (_, b) in zip(got, want):
                worst["profile_bytes"] = max(worst["profile_bytes"],
                                             abs(g - b) / max(b, 1))
        return [Check(n, float(v), 0.0) for n, v in sorted(worst.items())]

    def _counters(self):
        k = self.seg_kernel
        return {"launches": k.launches, "iterations": k.iterations,
                "passes": k.passes}

    # -- the window -----------------------------------------------------------

    def window(self, seconds: float, spans: Spans) -> None:
        self._spans = spans
        gen = traffic.stream(self.mix, self.seed)
        cycle = int(self.mix["cycle"])
        self.before = self._counters()
        self.t0_ns = time.time_ns()
        t0 = time.perf_counter()
        with spans.span("window"):
            while True:
                req = next(gen)
                ts = time.perf_counter()
                with spans.span("request"):
                    rep = self._emulate((req.prompt, req.output),
                                        window=True)
                te = time.perf_counter()
                self.records.append((req, ts, te, rep))
                if te - t0 >= seconds and (req.index + 1) % cycle == 0:
                    break
        self.t1_ns = time.time_ns()
        self.window_s = te - t0
        self.after = self._counters()
        self.attempted = len(self.records)
        req = [e - b for n, b, e in spans.done if n == "request"]
        seg = [e - b for n, b, e in spans.done if n == "segment.run"]
        host = sorted((r - g) / 1e6 for r, g in zip(req, seg))
        seg = sorted(g / 1e6 for g in seg)
        log(f"window {self.window_s:.3f} s, {len(req)} requests; host ms "
            f"a request min {host[0]:.2f} median {host[len(host) // 2]:.2f}"
            f" max {host[-1]:.2f} sum {sum(host):.1f}; segment ms sum "
            f"{sum(seg):.1f}")

    def end_to_end(self) -> Dict[str, float]:
        return {"emulate_req_per_s": len(self.records) / self.window_s}

    def facts(self) -> Dict:
        win = [c for c in self.calls if c["window"]]
        roof = sum(emu_ref.roofline_s(self.profiles[c["key"]].samples,
                                      peaks.FP32_FLOPS,
                                      peaks.HBM_BYTES_PER_S) for c in win)
        bound = sum(emu_ref.rows_bound_s(self._runs(c["key"]),
                                         peaks.FP32_FLOPS,
                                         peaks.HBM_BYTES_PER_S)
                    for c in win)
        return {"requests": len(win), "roofline_s": roof,
                "segment_bound_s": bound,
                "segment_launches": self.after["launches"]
                - self.before["launches"],
                "segment_symbol": "segment_kernel"}

    def counts(self) -> Dict:
        return {"requests": len(self.records),
                "distinct_profiles": len(self.profiles),
                "rows": sum(len(self._runs(k)) for k in self.profiles)}

    def release(self) -> None:
        for mod, name, orig in self._restore:
            setattr(mod, name, orig)

    # -- the checks -----------------------------------------------------------

    def checks(self) -> List[Check]:
        import torch
        checks = self._profile_checks()
        rows_bad = consumed_bad = 0.0
        burn_err = 0.0
        want = {"launches": 0, "iterations": 0, "passes": 0}
        total_passes = 0
        burns: Dict[int, torch.Tensor] = {}
        for c in self.calls:
            rs = self._runs(c["key"])
            tab = emu_ref.table(rs, self.tile, self.block)
            total_passes += int(tab[:, 1].sum())
            segs = [s for sched in c["schedules"] for s in sched.steps]
            if len(segs) != 1 or not hasattr(segs[0], "table"):
                rows_bad += len(tab)
            else:
                got = np.asarray(segs[0].table, dtype=np.int64)
                if got.shape != tab.shape:
                    rows_bad += max(len(got), len(tab))
                else:
                    rows_bad += int((got != tab).any(axis=1).sum())
            f, b = emu_ref.fold(rs)
            rep = c["report"]
            consumed_bad = max(consumed_bad,
                               abs(rep.consumed.flops - f) / max(f, 1.0),
                               abs(rep.consumed.hbm_bytes - b) / max(b, 1.0))
            if not c["window"]:
                continue
            ci = int(tab[:, 0].sum())
            want["launches"] += int(bool(tab[:, :2].any()))
            want["iterations"] += ci
            want["passes"] += int(tab[:, 1].sum())
            ys = [r.y for r in c["launched"] if r.y is not None]
            if ci:
                if len(ys) != 1:
                    burn_err = float("inf")
                    continue
                if ci not in burns:
                    burns[ci] = emu_ref.burn(self.tile, ci, ys[0].device)
                burn_err = max(burn_err,
                               (ys[0] - burns[ci]).abs().max().item())
        checks += [Check("table_rows", rows_bad, 0.0),
                   Check("consumed", consumed_bad, 0.0),
                   Check("burn_err", burn_err, 0.0)]
        ring = self.em.memory.ring()
        expect = torch.from_numpy(emu_ref.ring_values_fast(
            ring.slots, total_passes)).to(ring.data.device)
        ring_err = (ring.data - expect[:, None]).abs().max().item() \
            if ring.passes == total_passes else float("inf")
        checks.append(Check("ring_err", ring_err, 0.0))
        if self.device.type == "cuda":
            for k in ("launches", "iterations", "passes"):
                got = self.after[k] - self.before[k]
                checks.append(Check("device_" + k, abs(got - want[k]), 0.0))
        return checks

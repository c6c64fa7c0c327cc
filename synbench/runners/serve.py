"""Prefill-only serving: ``Engine.serve`` takes the mix's requests in waves
of ``batch_slots``, in arrival order, each request asking for one token.
Closed loop, one client: each wave starts when the last one ends; the
window closes at the first cycle's end after ``--seconds`` (every seed
then serves whole cycles, the same waves in another order).  A request's
time to first token runs from its wave's start until its token is on the
host.

The weights are the benchmark's, made on the card from the seed in the
dtype they are served in (one draw for all of them), in the layout the
program takes.  Set-up serves one wave of each padded length the cycle
holds, so nothing new is planned inside the window.

Inside the window the runner keeps the logits the program's output head
returns at each wave's last position (one [B, 1, V] tensor a wave: the
rows the served tokens are drawn from).  The checks, after the window and
with the program's state freed: every served token is a largest logit of
its row; and over a sample of the finished requests drawn from the seed,
the longest prompt among them, each run once through the plain float32
forward over the row the program computed (the prompt left-padded with
token 0 to its wave's longest, run over as the engine does), the largest
gap between the program's logit row and the reference's, over the
reference row's standard deviation (the reference's ``logit_err``),
under the configuration file's limit where it states one, else the
mix's.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List

import numpy as np

from synbench.core import peaks, stats, traffic
from synbench.core.harness import Check, log
from synbench.core.spans import Spans

#: what this runner calls on the configuration's reference module
#: (``reference/<name>.py``); ``flash_launch(config, B, S)`` too where
#: ``flash_layers(config)``, the flash launches of one prefill, is above 0
REFERENCE_NEEDS = ("port_fields", "dims", "weight_shapes", "weight_std",
                   "shapes_match", "request_flops", "flash_layers",
                   "final_hidden", "head", "logit_err")


def logit_err_limit(cell, rehearse: bool) -> float:
    """The cell's ``logit_err`` limit: its configuration file's
    (``rehearsal_logit_err_limit`` at the rehearsal size, where readings
    differ), else its mix's."""
    key = "rehearsal_logit_err_limit" if rehearse else "logit_err_limit"
    if key in cell.config:
        return float(cell.config[key])
    return float(cell.mix["logit_err_limit"])


def make_weights(shapes: Dict, std, seed: int, device, dtype):
    """A tree of tensors of ``shapes``, drawn from ``seed`` on ``device``
    in ``dtype`` with one call for all of them, each leaf a view of the
    standard normal draw scaled by ``std(path, shape)``, or, where that
    is a function, set to what it makes of the draw (in float32)."""
    import torch
    leaves = []

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                leaves.append((path + (k,), tuple(v)))
    walk(shapes, ())
    total = sum(int(np.prod(s)) for _, s in leaves)
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=g, dtype=dtype, device=device)
    out: Dict = {}
    at = 0
    for path, shape in leaves:
        n = int(np.prod(shape))
        t = flat[at:at + n].view(shape)
        s = std(path, shape)
        if callable(s):
            t.copy_(s(t.float()))
        else:
            t.mul_(s)
        at += n
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return out


class Runner:
    def __init__(self, cell, ref, device, seed: int, rehearse: bool):
        self.cell, self.ref, self.device = cell, ref, device
        self.seed, self.rehearse = seed, rehearse
        self.mix = cell.mix
        self.B = int(self.mix["batch_slots"])
        self.waves: List[dict] = []
        self.attempted = self.failed = 0
        self.window_s = 0.0
        self.t0_ns = self.t1_ns = 0

    def setup(self) -> None:
        import torch
        from repro_torch.configs.run import SERVE_RUN
        from repro_torch.kernels.flash_attention import kernel as fk
        from repro_torch.models.model_zoo import build_model
        from repro_torch.serve.engine import Engine
        from synbench.runners.common import port_config

        self.fk = fk
        cfg = port_config(self.cell, self.ref, self.rehearse)
        model = build_model(cfg, dataclasses.replace(
            SERVE_RUN, attn_impl=self.mix["attention"],
            block_q=int(self.mix["block_q"]),
            block_kv=int(self.mix["block_kv"])))
        # the output head's logits, kept while ``self.kept`` is a list
        self.kept = None
        logits = model.logits

        def kept_logits(params, hidden):
            out = logits(params, hidden)
            if self.kept is not None:
                self.kept.append(out)
            return out
        model = dataclasses.replace(model, logits=kept_logits)
        sizes = self.cell.sizes
        shapes = self.ref.weight_shapes(sizes)
        bad = self.ref.shapes_match(model.abstract(), shapes)
        if bad:
            raise SystemExit(f"synbench: the program's weight {bad} has "
                             f"another shape than the reference's")
        t = time.perf_counter()
        self.weights = make_weights(shapes, self.ref.weight_std, self.seed,
                                    self.device, torch.bfloat16)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        log(f"weights made in {time.perf_counter() - t:.3f} s")
        self.vocab = self.ref.dims(sizes)["V"]
        longest = max(p for g in traffic.cycle(self.mix) for p, _ in g)
        most = max(o for g in traffic.cycle(self.mix) for _, o in g)
        self.engine = Engine(model, self.weights, batch_slots=self.B,
                             max_len=longest + most, device=self.device)
        # one wave of each padded length the traffic brings
        took = []
        for i, group in enumerate(traffic.cycle(self.mix)):
            t = time.perf_counter()
            self._serve(group, 10 ** 12 + i * self.B)
            took.append(round(time.perf_counter() - t, 3))
        log(f"warm-up waves took {took} s")

    def _requests(self, lens, first_index: int):
        from repro_torch.serve.engine import Request
        return [Request(prompt=traffic.token_ids(
            self.seed, first_index + j, p, self.vocab).tolist(),
            max_new_tokens=o) for j, (p, o) in enumerate(lens)]

    def _serve(self, lens, first_index: int):
        reqs = self._requests(lens, first_index)
        self.engine.serve(reqs)
        return reqs

    # -- the window -----------------------------------------------------------

    def window(self, seconds: float, spans: Spans) -> None:
        gen = traffic.stream(self.mix, self.seed)
        per_cycle = len(traffic.cycle(self.mix))
        self.launches0 = self.fk.launches
        self.kept = []
        pending = next(gen)
        self.t0_ns = time.time_ns()
        t0 = time.perf_counter()
        with spans.span("window"):
            while True:
                wave = [pending]
                for r in gen:
                    if r.group != wave[0].group:
                        pending = r
                        break
                    wave.append(r)
                reqs = self._requests([(r.prompt, r.output) for r in wave],
                                      wave[0].index)
                n = len(self.kept)
                ts = time.perf_counter()
                with spans.span("wave"):
                    self.engine.serve(reqs)
                te = time.perf_counter()
                # one prefill a wave: exactly one logits tensor
                got = self.kept[n:]
                self.waves.append({"meta": wave, "reqs": reqs, "t0": ts,
                                   "t1": te, "logits": got[0]
                                   if len(got) == 1 else None})
                if te - t0 >= seconds and len(self.waves) % per_cycle == 0:
                    break
        self.t1_ns = time.time_ns()
        self.kept = None
        self.window_s = te - t0
        self.launches = self.fk.launches - self.launches0
        self.attempted = sum(len(w["reqs"]) for w in self.waves)

    def end_to_end(self) -> Dict[str, float]:
        toks = sum(r.prompt for w in self.waves for r in w["meta"])
        ttft = [w["t1"] - w["t0"] for w in self.waves
                for _ in w["reqs"]]
        return {"prefill_tok_per_s": toks / self.window_s,
                "ttft_p95_ms": 1e3 * stats.percentile(ttft, 95)}

    def facts(self) -> Dict:
        sizes = self.cell.sizes
        L = self.ref.flash_layers(sizes)
        useful = sum(self.ref.request_flops(sizes, r.prompt)
                     for w in self.waves for r in w["meta"])
        bound = 0.0
        if L:
            for w in self.waves:
                S = max(r.prompt for r in w["meta"])
                f, b = self.ref.flash_launch(sizes, self.B, S)
                bound += L * max(f / peaks.BF16_FLOPS,
                                 b / peaks.HBM_BYTES_PER_S)
        return {"requests": self.attempted, "useful_flops": useful,
                "flash_bound_s": bound, "flash_launches": self.launches,
                "flash_symbol": "fa_sm90"}

    def counts(self) -> Dict:
        return {"waves": len(self.waves), "requests": self.attempted,
                "flash_launches": self.launches}

    def release(self) -> None:
        import torch
        del self.engine
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the checks -----------------------------------------------------------

    def sample(self) -> List[tuple]:
        """(row tokens, the program's logits at its last position or None)
        of the requests the check runs: the longest prompt, then others
        drawn from the seed."""
        done = [(w, i) for w in self.waves for i in range(len(w["reqs"]))]
        k = min(int(self.mix["check_requests"]), len(done))
        longest = max(range(len(done)),
                      key=lambda j: done[j][0]["meta"][done[j][1]].prompt)
        rng = np.random.default_rng([self.seed, 7])
        rest = [j for j in rng.permutation(len(done)) if j != longest]
        out = []
        for j in [longest] + rest[:k - 1]:
            w, i = done[j]
            plen = max(len(r.prompt) for r in w["reqs"])
            p = w["reqs"][i].prompt
            row = np.zeros(plen, dtype=np.int64)
            row[plen - len(p):] = p
            got = w["logits"]
            out.append((row, None if got is None else got[i, -1]))
        return out

    def reference_logits(self, picked):
        """The float32 reference's logits [k, V] at the last position of
        each picked row."""
        import torch
        prev = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            rows = [torch.from_numpy(r) for r, _ in picked]
            with torch.no_grad():
                hidden = self.ref.final_hidden(self.weights, rows,
                                               self.cell.sizes)
                return self.ref.head(self.weights, torch.stack(
                    [h[-1] for h in hidden]), self.cell.sizes)
        finally:
            torch.backends.cuda.matmul.allow_tf32, \
                torch.backends.cudnn.allow_tf32 = prev

    def program_errs(self, picked, ref_logits) -> List[float]:
        """Each picked row's ``logit_err`` of the program's logits (inf
        where the window kept none)."""
        return [float("inf") if got is None else
                self.ref.logit_err(got[None], ref[None])[0]
                for (_, got), ref in zip(picked, ref_logits)]

    def _not_max(self) -> int:
        """Requests whose served token is not a largest logit of the row
        the program drew it from (every request of the window)."""
        import torch
        bad = 0
        for w in self.waves:
            if w["logits"] is None:
                bad += len(w["reqs"])
                continue
            rows = w["logits"][:len(w["reqs"]), -1].float()
            tok = torch.tensor([r.out_tokens[0] for r in w["reqs"]],
                               device=rows.device)
            hit = rows.gather(1, tok[:, None])[:, 0]
            bad += int((hit < rows.max(-1).values).sum())
        return bad

    def checks(self) -> List[Check]:
        bad = 0
        for w in self.waves:
            for r, m in zip(w["reqs"], w["meta"]):
                if len(r.out_tokens) != m.output or not all(
                        0 <= t < self.vocab for t in r.out_tokens):
                    bad += 1
        self.failed = bad
        # a token outside the vocabulary indexes no row: none is read
        not_max = self._not_max() if not bad else self.attempted
        t = time.perf_counter()
        picked = self.sample()
        errs = self.program_errs(picked, self.reference_logits(picked))
        log(f"reference over {len(errs)} requests in "
            f"{time.perf_counter() - t:.3f} s; logit errs {errs}")
        return [Check("tokens", float(bad), 0.0),
                Check("served_not_max", float(not_max), 0.0),
                Check("logit_err", max(errs),
                      logit_err_limit(self.cell, self.rehearse))]

"""Batched serving engine: static-batch prefill+decode over a request queue.

The JAX package's single-host serving layer: fixed-size batch slots, greedy
sampling, per-slot stop lengths.  Prompts of a wave are left-padded to the
longest with token 0 and no padding mask: the model attends to the pad
tokens, as the JAX package's does.  The Synapse ``RuntimeProfiler`` can
profile ``serve`` like any callable.

On a mesh (a ``DeviceMesh`` over the ranks of a process group, each rank
serving the same requests), plain parameters are laid out by the decode
rules' specs, the steps run on DTensors, and each token is read whole on
every rank.

Spans (``obs.spans``, while tracing), one tree a wave: ``serve.wave``
(attributes ``prompt_tokens`` and ``positions``), with ``serve.pad`` (the
padded token matrix to the device), ``serve.prefill`` (the prefill step's
call: the host's enqueue) and ``serve.first_token`` (the wait for the
first tokens on the host).  Counters ``serve.prompt_tokens`` (the wave's
real prompt tokens) and ``serve.positions`` (slots x padded length, the
positions prefilled).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve
from repro_torch.models.model_zoo import Model
from repro_torch.models.params import place
from repro_torch.obs import spans
from repro_torch.parallel.sharding import DECODE_RULES, make_rules, whole
from repro_torch.serve.step import make_decode_step, make_prefill_step


@dataclass
class Request:
    prompt: List[int]
    max_new_tokens: int = 16
    out_tokens: List[int] = field(default_factory=list)
    done: bool = False


class Engine:
    def __init__(self, model: Model, params, *, batch_slots: int = 4,
                 max_len: int = 256, mesh=None, device: DeviceLike = None):
        """``params`` live on ``device`` (``"cuda"`` unless named; on a
        ``mesh``, the rank's device, whole: the engine lays them out)."""
        self.device = resolve(device)
        self.model = model
        self.mesh = mesh
        if mesh is not None:
            params = place(params, mesh, model.param_specs(
                make_rules(mesh, DECODE_RULES)))
        self.params = params
        self.B = batch_slots
        self.max_len = max_len
        self.prefill = make_prefill_step(model, max_len, mesh=mesh)
        self.decode = make_decode_step(model, mesh=mesh)

    def serve(self, requests: List[Request]) -> List[Request]:
        """Static batching: pad the wave to batch_slots, prefill, decode to
        the longest max_new_tokens, per-request early stop bookkeeping."""
        # on a mesh no_grad, not inference_mode: DTensor's views set the
        # version counters that inference tensors lack
        with torch.inference_mode() if self.mesh is None else \
                torch.no_grad():
            for wave_start in range(0, len(requests), self.B):
                wave = requests[wave_start:wave_start + self.B]
                self._serve_wave(wave)
        return requests

    def _serve_wave(self, wave: List[Request]):
        B = self.B
        plen = max(len(r.prompt) for r in wave)
        with spans.span("serve.wave") as root:
            if root is not None:
                tokens = sum(len(r.prompt) for r in wave)
                root.attrs.update(prompt_tokens=tokens, positions=B * plen)
                root.count("serve.prompt_tokens", tokens)
                root.count("serve.positions", B * plen)
            with spans.span("serve.pad"):
                toks = np.zeros((B, plen), np.int32)
                for i, r in enumerate(wave):
                    toks[i, plen - len(r.prompt):] = r.prompt   # left-pad
                batch = {"tokens": torch.from_numpy(toks).to(self.device)}
            with spans.span("serve.prefill"):
                tok, cache = self.prefill(self.params, batch)
            steps = max(r.max_new_tokens for r in wave)
            with spans.span("serve.first_token"):
                t = whole(tok).cpu().numpy()
            for i, r in enumerate(wave):
                r.out_tokens.append(int(t[i, 0]))
            for _ in range(steps - 1):
                tok, cache = self.decode(self.params, tok, cache)
                t = whole(tok).cpu().numpy()
                for i, r in enumerate(wave):
                    if not r.done and len(r.out_tokens) < r.max_new_tokens:
                        r.out_tokens.append(int(t[i, 0]))
                    else:
                        r.done = True
        for r in wave:
            r.done = True

"""Batched serving engine: static-batch prefill+decode over a request queue.

The JAX package's single-host serving layer: fixed-size batch slots, greedy
sampling, per-slot stop lengths.  Prompts of a wave are left-padded to the
longest with token 0 and no padding mask: the model attends to the pad
tokens, as the JAX package's does.  The Synapse ``RuntimeProfiler`` can
profile ``serve`` like any callable.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve
from repro_torch.models.model_zoo import Model
from repro_torch.serve.step import make_decode_step, make_prefill_step


@dataclass
class Request:
    prompt: List[int]
    max_new_tokens: int = 16
    out_tokens: List[int] = field(default_factory=list)
    done: bool = False


class Engine:
    def __init__(self, model: Model, params, *, batch_slots: int = 4,
                 max_len: int = 256, device: DeviceLike = None):
        """``params`` live on ``device`` (``"cuda"`` unless named)."""
        self.device = resolve(device)
        self.model = model
        self.params = params
        self.B = batch_slots
        self.max_len = max_len
        self.prefill = make_prefill_step(model, max_len)
        self.decode = make_decode_step(model)

    def serve(self, requests: List[Request]) -> List[Request]:
        """Static batching: pad the wave to batch_slots, prefill, decode to
        the longest max_new_tokens, per-request early stop bookkeeping."""
        with torch.inference_mode():
            for wave_start in range(0, len(requests), self.B):
                wave = requests[wave_start:wave_start + self.B]
                self._serve_wave(wave)
        return requests

    def _serve_wave(self, wave: List[Request]):
        B = self.B
        plen = max(len(r.prompt) for r in wave)
        toks = np.zeros((B, plen), np.int32)
        for i, r in enumerate(wave):
            toks[i, plen - len(r.prompt):] = r.prompt   # left-pad
        tok, cache = self.prefill(
            self.params, {"tokens": torch.from_numpy(toks).to(self.device)})
        steps = max(r.max_new_tokens for r in wave)
        t = tok.cpu().numpy()
        for i, r in enumerate(wave):
            r.out_tokens.append(int(t[i, 0]))
        for _ in range(steps - 1):
            tok, cache = self.decode(self.params, tok, cache)
            t = tok.cpu().numpy()
            for i, r in enumerate(wave):
                if not r.done and len(r.out_tokens) < r.max_new_tokens:
                    r.out_tokens.append(int(t[i, 0]))
                else:
                    r.done = True
        for r in wave:
            r.done = True

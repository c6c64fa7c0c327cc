"""Model factory: one uniform interface over the ported architectures.

``build_model(cfg, run)`` returns a ``Model`` whose members close over the
config, as in the JAX package.  The dense family is ported; the others
raise ``NotImplementedError`` naming their ROADMAP.md item.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.run import RunConfig
from repro_torch.device import DeviceLike
from repro_torch.models import transformer as tr
from repro_torch.models.params import count_params, init_params

#: families of the JAX package's zoo that the port does not build yet
FAMILY_TODO = {
    "moe": "ROADMAP.md queue 1, item 7c (mixture of experts)",
    "vlm": "ROADMAP.md queue 1, item 7d (vision-language frontend)",
    "ssm": "ROADMAP.md queue 1, item 7e (state-space and hybrid blocks)",
    "hybrid": "ROADMAP.md queue 1, item 7e (state-space and hybrid blocks)",
    "encdec": "ROADMAP.md queue 1, item 7f (encoder-decoder)",
}


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    run: RunConfig
    pdefs: Dict[str, Any]
    forward: Callable          # (params, batch, cache=None, decode=False)
    init_cache: Callable       # (batch, max_len, device=None) -> cache
    logits: Callable           # (params, hidden) -> logits

    def init(self, generator: torch.Generator, device: DeviceLike = None):
        """Random parameters in ``run.param_dtype`` on ``device`` (``"cuda"``
        unless named), drawn from ``generator``, which lives there."""
        return init_params(self.pdefs, generator, self.run.pdtype, device)

    def num_params(self) -> int:
        return count_params(self.pdefs)


def build_model(cfg: ModelConfig, run: RunConfig) -> Model:
    if cfg.family != "dense":
        where = FAMILY_TODO.get(cfg.family, "ROADMAP.md queue 1, item 7")
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet: {where}")
    pdefs = tr.def_lm(cfg)

    def forward(params, batch, cache=None, decode=False):
        return tr.forward_lm(params, batch, cfg=cfg, run=run, cache=cache,
                             decode=decode)

    def initc(batch, max_len, device=None):
        return tr.init_cache(cfg, run, batch, max_len, device=device)

    def logits(params, hidden):
        return tr.lm_logits(params, hidden, cfg, run)

    return Model(cfg=cfg, run=run, pdefs=pdefs, forward=forward,
                 init_cache=initc, logits=logits)

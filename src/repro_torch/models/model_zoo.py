"""Model factory: one uniform interface over all assigned architectures.

``build_model(cfg, run)`` returns a ``Model`` whose members close over the
config, as in the JAX package: everything downstream (train step, serve
engine, dry-run, Synapse profiler) is family-agnostic.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.run import RunConfig
from repro_torch.device import DeviceLike
from repro_torch.models import encdec as encdec_lib
from repro_torch.models import hybrid as hybrid_lib
from repro_torch.models import transformer as tr
from repro_torch.models.params import (abstract_params, count_params,
                                       init_params, spec_tree)


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    run: RunConfig
    pdefs: Dict[str, Any]
    forward: Callable          # (params, batch, cache=None, decode=False)
    init_cache: Callable       # (batch, max_len, src_len=None, device=None)
    logits: Callable           # (params, hidden) -> logits

    def init(self, generator: torch.Generator, device: DeviceLike = None):
        """Random parameters in ``run.param_dtype`` on ``device`` (``"cuda"``
        unless named), drawn from ``generator``, which lives there."""
        return init_params(self.pdefs, generator, self.run.pdtype, device)

    def abstract(self, mesh=None, rules=None):
        """The parameters with no data: meta tensors, or DTensors with
        meta shards on ``mesh`` (``params.abstract_params``)."""
        return abstract_params(self.pdefs, self.run.pdtype, mesh, rules)

    def param_specs(self, rules):
        return spec_tree(self.pdefs, rules)

    def num_params(self) -> int:
        return count_params(self.pdefs)


def build_model(cfg: ModelConfig, run: RunConfig) -> Model:
    if cfg.family == "encdec":
        pdefs = encdec_lib.def_encdec(cfg)

        def forward(params, batch, cache=None, decode=False):
            return encdec_lib.forward_encdec(params, batch, cfg=cfg, run=run,
                                             cache=cache, decode=decode)

        def initc(batch, max_len, src_len=None, device=None):
            return encdec_lib.init_encdec_cache(
                cfg, run, batch, max_len, src_len or max_len, device=device)

    elif cfg.family in ("ssm", "hybrid"):
        if cfg.family == "ssm":
            pdefs = hybrid_lib.def_ssm_lm(cfg)
            block = hybrid_lib.make_ssm_block(cfg, run)

            def initc(batch, max_len, src_len=None, device=None):
                return hybrid_lib.init_ssm_cache(cfg, run, batch,
                                                 device=device)
        else:
            pdefs = hybrid_lib.def_hybrid_lm(cfg)
            block = hybrid_lib.make_hybrid_block(cfg, run)

            def initc(batch, max_len, src_len=None, device=None):
                return hybrid_lib.init_hybrid_cache(cfg, run, batch, max_len,
                                                    device=device)

        def forward(params, batch, cache=None, decode=False):
            return tr.forward_stack(params, batch, cfg=cfg, run=run,
                                    block_fn=block, cache=cache, decode=decode)

    else:  # dense | moe | vlm (decoder-only transformer)
        pdefs = tr.def_lm(cfg)

        def forward(params, batch, cache=None, decode=False):
            return tr.forward_lm(params, batch, cfg=cfg, run=run, cache=cache,
                                 decode=decode)

        def initc(batch, max_len, src_len=None, device=None):
            return tr.init_cache(cfg, run, batch, max_len, device=device)

    def logits(params, hidden):
        return tr.lm_logits(params, hidden, cfg, run)

    return Model(cfg=cfg, run=run, pdefs=pdefs, forward=forward,
                 init_cache=initc, logits=logits)

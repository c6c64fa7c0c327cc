"""Fanout-straggler scenario: N parallel workers, one tail-latency outlier.

A planner fanning work out to ``n_workers`` identical workers, except one
straggler doing ``straggler_factor``× the work — the classic p99-hides-in-
the-mean shape (aggregate metrics look healthy while batch completion is
gated on the one slow worker).  Profile samples are ordered, so the
straggler shows up as the sample that dominates TTC; ``meta`` records which
one so analysis tools don't have to rediscover it.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.metrics import ResourceVector, Sample, SynapseProfile
from repro_torch.scenarios.base import register


@register("fanout_straggler",
          n_workers=8, work_flops=5e7, work_hbm=8e6,
          straggler_factor=6.0, straggler_index=-1, jitter=0.05, seed=0)
def fanout_straggler(n_workers: int, work_flops: float, work_hbm: float,
                     straggler_factor: float, straggler_index: int,
                     jitter: float, seed: int) -> SynapseProfile:
    """N parallel workers with one straggler_factor× tail outlier."""
    if n_workers < 1 or straggler_factor < 1.0:
        raise ValueError("fanout_straggler needs n_workers >= 1 and "
                         "straggler_factor >= 1")
    rng = np.random.default_rng(seed)
    idx = straggler_index if 0 <= straggler_index < n_workers \
        else int(rng.integers(n_workers))
    samples = []
    for i in range(n_workers):
        noise = 1.0 + jitter * float(rng.standard_normal()) if jitter else 1.0
        scale = max(noise, 0.1) * (straggler_factor if i == idx else 1.0)
        rv = ResourceVector(flops=work_flops * scale,
                            hbm_bytes=work_hbm * scale)
        samples.append(Sample(index=i, resources=rv,
                              label="straggler" if i == idx else "worker"))
    return SynapseProfile(command="scenario:fanout_straggler", samples=samples,
                          meta={"straggler_index": idx,
                                "straggler_factor": straggler_factor})

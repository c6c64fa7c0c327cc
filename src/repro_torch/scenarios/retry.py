"""Retry-storm scenario: flaky work re-consumed under exponential backoff.

Each of ``n_tasks`` consumes its full resource vector per attempt; an
attempt fails with probability ``error_rate`` (up to ``max_retries``
retries, the final attempt always lands), and retry k waits
``backoff_base_s · 2^(k-1)`` first — recorded as the sample's
``duration_s``.  The aggregate symptom this synthesizes: load amplification
with no increase in offered traffic, plus intermittent latency spikes from
the backoff tail.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.metrics import ResourceVector, Sample, SynapseProfile
from repro_torch.scenarios.base import register


@register("retry_storm",
          n_tasks=6, error_rate=0.3, max_retries=3,
          work_flops=5e7, work_hbm=4e6, backoff_base_s=0.01, seed=0)
def retry_storm(n_tasks: int, error_rate: float, max_retries: int,
                work_flops: float, work_hbm: float, backoff_base_s: float,
                seed: int) -> SynapseProfile:
    """Flaky tasks whose failures re-consume work with exponential backoff."""
    if n_tasks < 1 or not 0.0 <= error_rate < 1.0:
        raise ValueError("retry_storm needs n_tasks >= 1, 0 <= error_rate < 1")
    rng = np.random.default_rng(seed)
    rv = ResourceVector(flops=float(work_flops), hbm_bytes=float(work_hbm))
    samples, attempts = [], []
    for task in range(n_tasks):
        attempt = 0
        while True:
            attempt += 1
            failed = attempt <= max_retries and rng.random() < error_rate
            backoff = backoff_base_s * 2 ** (attempt - 2) if attempt > 1 \
                else 0.0
            tag = "fail" if failed else "ok"
            samples.append(Sample(index=len(samples), resources=rv,
                                  duration_s=backoff,
                                  label=f"task{task}:try{attempt}:{tag}"))
            if not failed:
                break
        attempts.append(attempt)
    return SynapseProfile(
        command="scenario:retry_storm", samples=samples,
        meta={"attempts": attempts, "total_attempts": sum(attempts),
              "amplification": sum(attempts) / n_tasks})

"""Mixed-fleet scenario: a weighted blend of the other scenario families.

Draws each of ``total_samples`` samples from a component scenario chosen by
weight (training/serving/fanout/retry by default), cycling through that
component's own sample stream.  This is the "production mix" knob: one
profile whose resource texture interleaves scan steps, request bursts,
stragglers and retries — and the stress case for the fleet plan cache,
which must dedup across families, not just within one.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from repro_torch.core.metrics import Sample, SynapseProfile
from repro_torch.scenarios.base import generate, get_scenario, register

DEFAULT_WEIGHTS = {"training_scan": 0.4, "serving_traffic": 0.3,
                   "fanout_straggler": 0.2, "retry_storm": 0.1}


@register("mixed_fleet", total_samples=16, weights=None, seed=0)
def mixed_fleet(total_samples: int, weights: Optional[Dict[str, float]],
                seed: int) -> SynapseProfile:
    """Weighted interleave of the registered scenario families."""
    if total_samples < 1:
        raise ValueError("mixed_fleet needs total_samples >= 1")
    weights = dict(weights or DEFAULT_WEIGHTS)
    if not weights or any(w < 0 for w in weights.values()) \
            or sum(weights.values()) <= 0:
        raise ValueError(f"bad mixed_fleet weights {weights}")
    rng = np.random.default_rng(seed)
    pools, cursors = {}, {}
    for name in sorted(weights):
        spec = get_scenario(name)
        kw = {"seed": seed} if "seed" in spec.defaults else {}
        pools[name] = generate(name, **kw).samples
        cursors[name] = 0
    names = sorted(weights)
    probs = np.array([weights[n] for n in names], dtype=float)
    probs /= probs.sum()
    samples = []
    for i in range(total_samples):
        name = names[int(rng.choice(len(names), p=probs))]
        src = pools[name][cursors[name] % len(pools[name])]
        cursors[name] += 1
        samples.append(Sample(index=i, resources=src.resources,
                              duration_s=src.duration_s,
                              label=f"{name}:{src.label}"))
    return SynapseProfile(
        command="scenario:mixed_fleet", samples=samples,
        meta={"weights": {n: float(weights[n]) for n in names},
              "component_draws": dict(cursors)})

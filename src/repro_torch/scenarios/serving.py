"""Serving-traffic scenario: Poisson arrivals over prefill/decode rooflines.

Each request becomes two ordered samples — a prefill vector (compute-heavy)
and a decode vector (memory-heavy) — built by
``predictor.llm_request_resources`` from a parameter count and token
budgets.  ``duration_s`` is the roofline ``t_max`` of the sample on the
reference HardwareSpec, so the synthesized profile carries a predicted
serving timeline; arrival times (exponential inter-arrival gaps at
``rate_hz``) live in ``meta["arrival_s"]``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.hardware import get_spec
from repro_torch.core.metrics import Sample, SynapseProfile
from repro_torch.core.predictor import llm_request_resources, terms_for
from repro_torch.scenarios.base import register


@register("serving_traffic",
          n_requests=8, rate_hz=50.0, prefill_tokens=128, decode_tokens=16,
          n_params=4e6, bytes_per_param=2.0, kv_bytes_per_token=0.0,
          hw="tpu_v5e", seed=0)
def serving_traffic(n_requests: int, rate_hz: float, prefill_tokens: int,
                    decode_tokens: int, n_params: float,
                    bytes_per_param: float, kv_bytes_per_token: float,
                    hw: str, seed: int) -> SynapseProfile:
    """Poisson request stream mapped to prefill/decode resource vectors."""
    if n_requests < 1 or rate_hz <= 0:
        raise ValueError("serving_traffic needs n_requests >= 1, rate_hz > 0")
    rng = np.random.default_rng(seed)
    spec = get_spec(hw)
    gaps = rng.exponential(1.0 / rate_hz, size=n_requests)
    prefill, decode = llm_request_resources(
        prefill_tokens, decode_tokens, n_params, bytes_per_param,
        kv_bytes_per_token)
    tp, td = terms_for(prefill, spec), terms_for(decode, spec)
    samples, arrivals, t = [], [], 0.0
    for i in range(n_requests):
        t += float(gaps[i])
        arrivals.append(t)
        samples.append(Sample(index=2 * i, resources=prefill,
                              duration_s=tp.t_max,
                              label=f"prefill:{tp.dominant}"))
        samples.append(Sample(index=2 * i + 1, resources=decode,
                              duration_s=td.t_max,
                              label=f"decode:{td.dominant}"))
    return SynapseProfile(
        command="scenario:serving_traffic", samples=samples,
        meta={"arrival_s": arrivals,
              "prefill_dominant": tp.dominant, "decode_dominant": td.dominant,
              "ref_hw": spec.name})

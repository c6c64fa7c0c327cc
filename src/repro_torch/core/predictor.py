"""TTC / roofline prediction from a Synapse profile + a HardwareSpec.

The paper estimates time-to-completion on resources the user has no access
to.  On a TPU pod the three per-chip roofline terms per the assignment:

    compute_s    = FLOPs_per_chip    / peak_FLOP/s
    memory_s     = HBM_bytes_per_chip/ HBM_bw
    collective_s = ICI_wire_bytes_per_chip / link_bw

Per-sample combination is ``max`` (perfect overlap — XLA/TPU overlaps DMA,
MXU and ICI) or ``sum`` (fully serial); the truth lies in between, exactly
the paper's §IV-D concurrency discussion, so both bounds are reported.
The dominant term per sample is the paper's Fig.-3 "dominant resource",
which flips across hardware — ``compare()`` reproduces that flip.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.core.hardware import HardwareSpec
from repro_torch.core.metrics import ResourceVector, SynapseProfile


@dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    storage_s: float = 0.0

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s, "storage": self.storage_s}
        return max(terms, key=terms.get)

    @property
    def t_max(self) -> float:           # perfect-overlap bound
        return max(self.compute_s, self.memory_s, self.collective_s,
                   self.storage_s)

    @property
    def t_sum(self) -> float:           # serial bound
        return (self.compute_s + self.memory_s + self.collective_s +
                self.storage_s)

    def to_dict(self):
        return {"compute_s": self.compute_s, "memory_s": self.memory_s,
                "collective_s": self.collective_s, "storage_s": self.storage_s,
                "dominant": self.dominant, "t_max": self.t_max,
                "t_sum": self.t_sum}


@dataclass
class Prediction:
    hw: str
    terms: RooflineTerms                 # totals
    per_sample: List[RooflineTerms] = field(default_factory=list)
    dominant_histogram: Dict[str, int] = field(default_factory=dict)

    @property
    def ttc_max(self) -> float:
        """Overlap-per-sample, ordered across samples (emulation contract)."""
        return sum(t.t_max for t in self.per_sample) if self.per_sample \
            else self.terms.t_max

    @property
    def ttc_sum(self) -> float:
        return self.terms.t_sum

    def roofline_fraction(self) -> float:
        """Fraction of TTC spent at the dominant-term ceiling: 1.0 means the
        workload saturates its bottleneck resource perfectly."""
        d = self.terms.dominant
        val = getattr(self.terms, f"{d}_s")
        return val / self.ttc_max if self.ttc_max else 0.0


def terms_for(r: ResourceVector, hw: HardwareSpec,
              storage_bps: Optional[float] = None) -> RooflineTerms:
    peak = hw.peak_flops * hw.flops_derate
    bw = hw.hbm_bw * hw.hbm_derate
    ici = hw.ici_bw * hw.ici_derate
    if storage_bps is None and hw.storage_bw:
        storage_bps = hw.storage_bw
    return RooflineTerms(
        compute_s=r.flops / peak if peak else 0.0,
        memory_s=r.hbm_bytes / bw if bw else 0.0,
        collective_s=r.ici_total / ici if ici else 0.0,
        storage_s=((r.storage_read_bytes + r.storage_write_bytes) /
                   storage_bps) if storage_bps else 0.0)


def predict(profile: SynapseProfile, hw: HardwareSpec,
            storage_bps: Optional[float] = None) -> Prediction:
    per_sample = [terms_for(s.resources, hw, storage_bps)
                  for s in profile.samples]
    total = terms_for(profile.totals, hw, storage_bps)
    hist: Dict[str, int] = {}
    for t in per_sample:
        hist[t.dominant] = hist.get(t.dominant, 0) + 1
    return Prediction(hw=hw.name, terms=total, per_sample=per_sample,
                      dominant_histogram=hist)


def predict_resources(r: ResourceVector, hw: HardwareSpec,
                      storage_bps: Optional[float] = None) -> Prediction:
    t = terms_for(r, hw, storage_bps)
    return Prediction(hw=hw.name, terms=t, per_sample=[t],
                      dominant_histogram={t.dominant: 1})


def compare(profile: SynapseProfile, specs: List[HardwareSpec]) -> Dict:
    """Paper Fig. 3: same profile, different machines — the dominant resource
    per sample flips while total consumption is invariant."""
    out = {}
    for hw in specs:
        p = predict(profile, hw)
        out[hw.name] = {"ttc_max": p.ttc_max, "ttc_sum": p.ttc_sum,
                        "dominant_total": p.terms.dominant,
                        "dominant_histogram": p.dominant_histogram}
    return out


def llm_request_resources(prefill_tokens: int, decode_tokens: int,
                          n_params: float, bytes_per_param: float = 2.0,
                          kv_bytes_per_token: float = 0.0
                          ) -> Tuple[ResourceVector, ResourceVector]:
    """Map one serving request to (prefill, decode) resource vectors.

    The standard LLM roofline split: prefill does 2·P flops per prompt token
    against one weight read (compute-bound for long prompts); decode does
    2·P flops per generated token but re-reads every weight byte per token
    (memory-bound).  ``terms_for`` on the returned vectors reproduces that
    dominant-resource flip on any HardwareSpec.
    """
    weight_bytes = n_params * bytes_per_param
    prefill = ResourceVector(
        flops=2.0 * n_params * prefill_tokens,
        hbm_bytes=weight_bytes + kv_bytes_per_token * prefill_tokens)
    # decode token i reads a context of prefill + i tokens; summed over the
    # generation that's an average context of prefill + decode/2
    decode = ResourceVector(
        flops=2.0 * n_params * decode_tokens,
        hbm_bytes=decode_tokens * (weight_bytes + kv_bytes_per_token *
                                   (prefill_tokens + decode_tokens / 2.0)))
    return prefill, decode


def predict_fleet(profiles: List[SynapseProfile], hw: HardwareSpec,
                  storage_bps: Optional[float] = None) -> Dict:
    """TTC bounds for a fleet of profiles sharing one machine.

    ``serial_s`` replays them back-to-back (sum of ordered-overlap TTCs);
    ``concurrent_lower_s`` is the roofline on the *summed* resource totals —
    no schedule can beat it on this hardware, so the pair brackets any real
    fleet execution.
    """
    preds = [predict(p, hw, storage_bps) for p in profiles]
    total = ResourceVector()
    for p in profiles:
        total = total.add(p.totals)
    agg = terms_for(total, hw, storage_bps)
    return {"hw": hw.name, "n_profiles": len(profiles),
            "serial_s": sum(p.ttc_max for p in preds),
            "concurrent_lower_s": agg.t_max,
            "dominant_total": agg.dominant,
            "per_profile": [{"ttc_max": p.ttc_max, "ttc_sum": p.ttc_sum,
                             "dominant": p.terms.dominant} for p in preds]}


def from_dryrun_artifact(rec: Dict) -> ResourceVector:
    """Per-chip ResourceVector from a dry-run JSON artifact (walker section).

    Memory term uses dot_bytes (MXU-streaming bytes) as primary — see
    DESIGN.md §2 caveats; hbm_bytes (all fusion boundaries) is the
    pessimistic bound kept in the artifact.
    """
    w = rec["walker"]
    return ResourceVector(
        flops=w["flops"],
        hbm_bytes=w.get("dot_bytes", w["hbm_bytes"]),
        ici_bytes=dict(w.get("collective_bytes", {})))

"""Synapse datamodel: resource vectors, samples, profiles.

Mirrors the paper's Table I, adapted to the TPU resource types of DESIGN.md §2:
compute (FLOPs on the MXU), memory (HBM bytes), collective (ICI wire bytes per
collective kind), storage (host I/O bytes), plus peak/live memory.  A profile
is an *ordered* sequence of samples (the paper's partial-order contract:
sample n may only depend on samples < n), plus totals, system info and tags.
"""
from __future__ import annotations

import dataclasses
import json
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                    "all-to-all", "collective-permute")


@dataclass
class ResourceVector:
    """Per-chip resource consumption (the unit Synapse atoms replay)."""
    flops: float = 0.0
    hbm_bytes: float = 0.0
    ici_bytes: Dict[str, float] = field(default_factory=dict)  # by kind
    storage_read_bytes: float = 0.0
    storage_write_bytes: float = 0.0
    host_mem_bytes: float = 0.0          # runtime watcher: resident memory
    peak_mem_bytes: float = 0.0

    @property
    def ici_total(self) -> float:
        return float(sum(self.ici_bytes.values()))

    def add(self, other: "ResourceVector") -> "ResourceVector":
        ici = dict(self.ici_bytes)
        for k, v in other.ici_bytes.items():
            ici[k] = ici.get(k, 0.0) + v
        return ResourceVector(
            flops=self.flops + other.flops,
            hbm_bytes=self.hbm_bytes + other.hbm_bytes,
            ici_bytes=ici,
            storage_read_bytes=self.storage_read_bytes + other.storage_read_bytes,
            storage_write_bytes=self.storage_write_bytes + other.storage_write_bytes,
            host_mem_bytes=max(self.host_mem_bytes, other.host_mem_bytes),
            peak_mem_bytes=max(self.peak_mem_bytes, other.peak_mem_bytes),
        )

    def scale(self, f: float) -> "ResourceVector":
        return ResourceVector(
            flops=self.flops * f, hbm_bytes=self.hbm_bytes * f,
            ici_bytes={k: v * f for k, v in self.ici_bytes.items()},
            storage_read_bytes=self.storage_read_bytes * f,
            storage_write_bytes=self.storage_write_bytes * f,
            host_mem_bytes=self.host_mem_bytes,
            peak_mem_bytes=self.peak_mem_bytes)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d) -> "ResourceVector":
        return ResourceVector(**d)


@dataclass
class Sample:
    """One profiling sample: a ResourceVector plus ordering/duration info.

    ``label`` identifies the program phase for phase-sampled (static) profiles
    or the wall-clock bucket index for time-sampled (runtime) profiles.
    """
    index: int
    resources: ResourceVector
    duration_s: Optional[float] = None   # known only for runtime samples
    label: str = ""

    def to_dict(self):
        return {"index": self.index, "resources": self.resources.to_dict(),
                "duration_s": self.duration_s, "label": self.label}

    @staticmethod
    def from_dict(d):
        return Sample(index=d["index"],
                      resources=ResourceVector.from_dict(d["resources"]),
                      duration_s=d.get("duration_s"), label=d.get("label", ""))


@dataclass
class SynapseProfile:
    """command + tags identify the workload (paper §IV: profile store keys)."""
    command: str
    tags: Dict[str, str] = field(default_factory=dict)
    samples: List[Sample] = field(default_factory=list)
    sysinfo: Dict[str, Any] = field(default_factory=dict)
    created_at: float = field(default_factory=time.time)
    meta: Dict[str, Any] = field(default_factory=dict)   # free-form extras

    @property
    def totals(self) -> ResourceVector:
        t = ResourceVector()
        for s in self.samples:
            t = t.add(s.resources)
        return t

    @property
    def wall_time_s(self) -> Optional[float]:
        ds = [s.duration_s for s in self.samples]
        if any(d is None for d in ds) or not ds:
            return None
        return float(sum(ds))

    def to_json(self) -> str:
        return json.dumps({
            "command": self.command, "tags": self.tags,
            "samples": [s.to_dict() for s in self.samples],
            "sysinfo": self.sysinfo, "created_at": self.created_at,
            "meta": self.meta,
        })

    @staticmethod
    def from_json(s: str) -> "SynapseProfile":
        d = json.loads(s)
        return SynapseProfile(
            command=d["command"], tags=d.get("tags", {}),
            samples=[Sample.from_dict(x) for x in d.get("samples", [])],
            sysinfo=d.get("sysinfo", {}), created_at=d.get("created_at", 0.0),
            meta=d.get("meta", {}))

    def key(self) -> str:
        tag = ",".join(f"{k}={v}" for k, v in sorted(self.tags.items()))
        return f"{self.command}|{tag}"

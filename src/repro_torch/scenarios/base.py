"""Scenario registry: parameterized generators that *synthesize* profiles.

The paper's core pitch is that synthetic profiles "can be tuned at arbitrary
levels of granularity in ways that are simply not possible using real
applications".  A scenario is that knob surface made first-class: a named,
parameterized generator that emits a well-formed ``SynapseProfile`` without
running any real application.  Generated profiles carry
``tags={"scenario": name, <param>: <value>, ...}`` so the store keys them
exactly like captured profiles, and every generator is deterministic in its
``seed`` parameter (where it has one).

Adding a scenario::

    @register("my_scenario", n=8, seed=0)
    def my_scenario(n, seed):
        return SynapseProfile(command="scenario:my_scenario", samples=[...])

Registration validates nothing; ``generate()`` applies defaults, stamps the
tags, and checks well-formedness (ordered sample indices, finite nonnegative
resource vectors) on every emitted profile.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List

from repro_torch.core.metrics import SynapseProfile

_REGISTRY: Dict[str, "ScenarioSpec"] = {}


@dataclass(frozen=True)
class ScenarioSpec:
    name: str
    fn: Callable[..., SynapseProfile]
    description: str
    defaults: Dict[str, object]


def register(name: str, description: str = "", **defaults):
    """Decorator: add a generator to the registry with default params."""
    def deco(fn: Callable[..., SynapseProfile]):
        if name in _REGISTRY:
            raise ValueError(f"scenario {name!r} already registered")
        doc = (fn.__doc__ or "").strip().splitlines()
        _REGISTRY[name] = ScenarioSpec(
            name=name, fn=fn,
            description=description or (doc[0] if doc else name),
            defaults=dict(defaults))
        return fn
    return deco


def get_scenario(name: str) -> ScenarioSpec:
    if name not in _REGISTRY:
        raise KeyError(f"unknown scenario {name!r}; "
                       f"registered: {list_scenarios()}")
    return _REGISTRY[name]


def list_scenarios() -> List[str]:
    return sorted(_REGISTRY)


def generate(name: str, **params) -> SynapseProfile:
    """Generate one profile: defaults + overrides -> generator -> validated,
    tagged ``SynapseProfile``."""
    spec = get_scenario(name)
    unknown = set(params) - set(spec.defaults)
    if unknown:
        raise TypeError(f"scenario {name!r} got unknown params {unknown}; "
                        f"accepts {sorted(spec.defaults)}")
    kw = {**spec.defaults, **params}
    profile = spec.fn(**kw)
    profile.tags["scenario"] = name
    for k, v in kw.items():
        if isinstance(v, (str, int, float, bool)) and v is not None:
            profile.tags.setdefault(k, str(v))
        elif isinstance(v, dict) and v:
            # dict params (e.g. mixed_fleet weights) must reach the store
            # key too, or different mixes collide as "repeated runs"
            profile.tags.setdefault(
                k, ",".join(f"{kk}={vv}" for kk, vv in sorted(v.items())))
    validate(profile)
    return profile


def validate(profile: SynapseProfile) -> None:
    """Well-formedness contract every generated profile must satisfy."""
    if not profile.samples:
        raise ValueError(f"{profile.command}: scenario emitted no samples")
    for i, s in enumerate(profile.samples):
        if s.index != i:
            raise ValueError(f"{profile.command}: sample indices must be "
                             f"0..n-1 in order, got {s.index} at {i}")
        r = s.resources
        fields = {"flops": r.flops, "hbm_bytes": r.hbm_bytes,
                  "storage_read_bytes": r.storage_read_bytes,
                  "storage_write_bytes": r.storage_write_bytes,
                  **{f"ici[{k}]": v for k, v in r.ici_bytes.items()}}
        for fname, val in fields.items():
            if not math.isfinite(val) or val < 0:
                raise ValueError(f"{profile.command}: sample {i} has bad "
                                 f"{fname}={val!r}")

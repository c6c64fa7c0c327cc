"""Serialization layer: detach compiled schedules into shippable bundles.

A ``ScheduleBundle`` is everything one fleet worker needs to replay one
profile, with every live object stripped out: the detached schedule payload
(plain ints/floats/dicts + one int32 table per segment, from
``CompiledSchedule.detach()``), the replay scales, and identification
metadata.  The emulator configuration travels separately — once per worker,
not once per bundle — as a ``WorkerSpec``: the parent's ``EmulatorSpec``
(calibration + atom configs) plus an optional ``MeshSpec`` describing the
device mesh each worker must build for itself, and the device the worker
replays on.  Meshes hold live device tensors, so they never cross the
process boundary; their *specs* do, which is what lets the
``CollectiveAtom`` take part in process-fleet mode.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from repro_torch.core.emulator import Emulator, EmulatorSpec
from repro_torch.core.metrics import ResourceVector, SynapseProfile
from repro_torch.core.schedule import CompiledSchedule, rehydrate_schedule
from repro_torch.device import DeviceLike
from repro_torch.fleet.chaos import ChaosPolicy


@dataclass(frozen=True)
class MeshSpec:
    """Picklable description of the mesh a worker builds on its own device
    (``repro_torch.launch.mesh.make_mesh``): every shard on that one
    device, the counterpart of the JAX package's forced host devices.  It
    validates as the JAX package's does.
    """
    shape: Tuple[int, ...] = (2,)
    axes: Tuple[str, ...] = ("model",)

    def __post_init__(self):
        if len(self.shape) != len(self.axes) or not self.shape:
            raise ValueError(f"mesh shape {self.shape} and axes {self.axes} "
                             "must be equal-length and non-empty")

    @property
    def device_count(self) -> int:
        return int(math.prod(self.shape))

    def build(self, device: DeviceLike = None):
        """Construct the live mesh on ``device`` (``"cuda"`` unless named)
        — call only inside the owning process."""
        from repro_torch.launch.mesh import make_mesh
        return make_mesh(self.shape, self.axes, device)


@dataclass(frozen=True)
class WorkerSpec:
    """Per-worker configuration shipped once at spawn: how to build the
    worker's emulator (and mesh), whether to pre-trace the common fused
    programs before accepting bundles, how often to heartbeat the
    coordinator (``heartbeat_s > 0`` starts a ``("ping",)`` sender thread
    in every worker and agent — the liveness watermark's signal), and an
    optional seeded ``ChaosPolicy`` whose faults every worker/agent
    spawned from this spec injects deterministically.  ``device`` is where
    the worker's emulator runs, named by the parent: a worker never picks
    one itself, and one asked for ``"cuda"`` where there is no card fails
    to initialize instead of replaying on the CPU."""
    emulator: EmulatorSpec
    mesh: Optional[MeshSpec] = None
    warmup: bool = True
    heartbeat_s: float = 0.0
    chaos: Optional[ChaosPolicy] = None
    device: str = "cuda"


@dataclass
class ScheduleBundle:
    """One profile's compiled schedule, detached for shipping.

    ``payload`` is the plain-data form from ``CompiledSchedule.detach()``;
    ``rehydrate()`` restores a ``CompiledSchedule`` whose tables and
    resource vectors are bit-identical to the originals, so a worker's
    ``Emulator.replay`` reports exactly the totals an in-process replay
    would.  The scales are baked in at bundle time because flop/byte
    amounts were already quantized into the tables with them applied —
    the barrier steps replayed per-sample on the worker need the same
    values.

    ``parents`` is the bundle's dependency edges: the stream indices of
    the bundles whose results must land before this one may dispatch
    (``FleetBase.stream``'s frontier scheduler enforces it).  The field
    is versioned the same way the v1/v2 detach payloads are: it defaults
    to ``()``, and bundles pickled before it existed deserialize without
    the attribute, so every consumer reads it through
    ``bundle_parents()`` — old bundles rehydrate *edge-free* and replay
    exactly as before.
    """
    command: str
    payload: Dict
    flops_scale: float = 1.0
    storage_scale: float = 1.0
    mem_scale: float = 1.0
    verify: bool = True
    n_profile_samples: int = 0
    planned: Optional[ResourceVector] = None
    tags: Dict[str, str] = field(default_factory=dict)
    parents: Tuple[int, ...] = ()

    def rehydrate(self) -> CompiledSchedule:
        return rehydrate_schedule(self.payload)


def bundle_parents(bundle) -> Tuple[int, ...]:
    """A bundle's dependency edges, tolerant of pre-``parents`` pickles
    (dataclass unpickling restores ``__dict__`` without calling
    ``__init__``, so old bundles simply lack the attribute): missing or
    empty means edge-free, exactly the pre-DAG behavior."""
    return tuple(getattr(bundle, "parents", ()) or ())


def bundle_profile(emulator: Emulator, profile: SynapseProfile, *,
                   keep_collectives: Optional[bool] = None,
                   mesh_spec: Optional[MeshSpec] = None,
                   flops_scale: float = 1.0, storage_scale: float = 1.0,
                   mem_scale: float = 1.0,
                   verify: bool = True,
                   parents: Tuple[int, ...] = ()) -> ScheduleBundle:
    """Compile one profile on ``emulator`` and detach it into a bundle.

    ``mesh_spec`` (the fleet's ``MeshSpec``) quantizes wire-byte runs into
    mesh-bound fused segments for the mesh each worker will build — this
    process needs no mesh, and the workers replay collectives inside their
    segments instead of per-sample barrier steps.
    ``keep_collectives=True`` is the barrier-step fallback for parents
    that know the workers own *a* mesh but not its shape.
    """
    if mesh_spec is None and keep_collectives is None \
            and emulator.collective is not None:
        # a mesh-owning parent compiling for workers of unknown mesh must
        # not bake ITS OWN mesh's quantization into the bundle — meshless
        # workers would refuse the mesh-bound segments.  Barrier steps are
        # the portable lowering (workers with a mesh execute them
        # per-sample, workers without one skip the wire and keep the
        # consumed accounting intact).
        keep_collectives = True
    sched = emulator.compile(profile, flops_scale=flops_scale,
                             mem_scale=mem_scale,
                             keep_collectives=keep_collectives,
                             mesh_spec=mesh_spec)
    return ScheduleBundle(command=profile.command, payload=sched.detach(),
                          flops_scale=flops_scale,
                          storage_scale=storage_scale, mem_scale=mem_scale,
                          verify=verify,
                          n_profile_samples=len(profile.samples),
                          planned=profile.totals, tags=dict(profile.tags),
                          parents=tuple(parents))

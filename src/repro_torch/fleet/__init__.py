"""Fleet execution: many profiles replayed at once, past one thread.

``Emulator.emulate_many`` replays a fleet of profiles concurrently; this
package supplies its ``executor="process"`` backend and the pieces every
executor shares.  The parent compiles each profile to a
``CompiledSchedule`` (plain numpy iteration tables and resource vectors),
detaches it into a picklable ``ScheduleBundle`` and ships it over a
``Pipe`` to a pool of spawn-based worker processes (``ProcessFleet``).
Each worker builds its own ``Emulator`` and ``SegmentRunner`` once, on
the device its ``WorkerSpec`` names, with its own CUDA context and plan
cache, then replays bundles fused and streams back ``EmulationReport``s
whose consumed totals are bit-identical to an in-process replay of the
same profile.  ``FleetBase`` is the transport-agnostic scheduler: the
compile-ahead window, the attempt budget, poison bundles, reap-requeue-
refill recovery, speculation, autoscaling, the DAG frontier and its
critical-path accounting.

Thread or process executor:

  * ``FleetConfig.thread()``: profiles replay on threads of this process,
    sharing one emulator and a fleet-wide ``PlanCache``.  No spawn cost;
    on the ``"cuda"`` backend the kernels of all threads share the
    current CUDA stream.  No chaos, no liveness, no DAG edges.
  * ``FleetConfig.process()``: one worker process a slot, on the
    ``"torch"`` backend (the fused path ships compiled tables).  Spawn,
    never fork: a forked child would inherit the parent's CUDA context.
    Workers on one card hold one CUDA context each and time-slice it.
    Worker deaths are reaped and their bundles requeued; a seeded
    ``ChaosPolicy`` injects reproducible faults; ``WorkloadDag``s are
    scheduled along their edges.

Not ported yet: the remote executor (``transport``, ``agent``) and
meshes (``MeshSpec`` validates, but building one needs the collective
atom).  Both raise ``NotImplementedError``.
"""
from repro_torch.fleet.bundle import (MeshSpec, ScheduleBundle,  # noqa: F401
                                      WorkerSpec, bundle_parents,
                                      bundle_profile)
from repro_torch.fleet.chaos import ChaosPolicy, derive_seed  # noqa: F401
from repro_torch.fleet.config import UNSET, FleetConfig  # noqa: F401
from repro_torch.fleet.dag import (critical_path,  # noqa: F401
                                   validate_parents)
from repro_torch.fleet.executor import (BundleTiming,  # noqa: F401
                                        CrashLoopError, FleetBase, Peer,
                                        PeerGone, ProcessFleet,
                                        run_process_fleet)

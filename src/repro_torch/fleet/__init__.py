"""Fleet execution: many profiles replayed at once, past one thread —
and past the host.

``Emulator.emulate_many`` replays a fleet of profiles concurrently; this
package supplies its ``executor="process"`` and ``executor="remote"``
backends and the pieces every executor shares.  The parent compiles each
profile to a ``CompiledSchedule`` (plain numpy iteration tables and
resource vectors), detaches it into a picklable ``ScheduleBundle`` and
ships it — over a ``Pipe`` to a pool of spawn-based worker processes
(``ProcessFleet``), or over framed TCP to host agents on other machines
(``RemoteFleet`` + ``python -m repro_torch.fleet.agent``).  Each worker
builds its own ``Emulator`` and ``SegmentRunner`` once, on the device its
``WorkerSpec`` names, with its own CUDA context and plan cache, then
replays bundles fused and streams back ``EmulationReport``s whose
consumed totals are bit-identical to an in-process replay of the same
profile.  ``FleetBase`` is the transport-agnostic scheduler: the
compile-ahead window, the attempt budget, poison bundles, reap-requeue-
refill recovery, speculation, autoscaling, the DAG frontier and its
critical-path accounting — the same whether the dead peer was a process
or a TCP connection.

Thread, process or remote executor:

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
  * ``FleetConfig.remote(hosts=[...] | listen=..., agents=N)``: the same
    bundles over TCP to host agents, each fronting a local
    ``ProcessFleet`` on the device the coordinator's ``WorkerSpec``
    names.  Dial listening agents or accept dial-in ones (late joiners
    enter mid-run); a dead agent is reaped like a dead worker; the chaos
    policy adds agent-side drop and corrupt-frame faults.  The frames are
    the JAX package's bytes, but their pickles name the port's classes.

A standing pool of either kind serves open-loop traffic through
``repro_torch.service.StandingFleet``.  Not ported yet: meshes
(``MeshSpec`` validates, but building one needs the collective atom;
it raises ``NotImplementedError``).
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
from repro_torch.fleet.transport.remote import (  # noqa: F401
    RemoteFleet, run_remote_fleet)

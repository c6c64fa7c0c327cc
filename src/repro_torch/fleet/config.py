"""One picklable knob surface for every fleet executor.

``FleetConfig`` collapses the executor sprawl that used to be duplicated
across ``Emulator.emulate_many``, ``repro_torch.scenarios.run_fleet`` and
the scenarios CLI — ``executor=``, ``max_workers=``, ``mesh_spec=``,
``hosts=``, ``listen=``, ``agents=``, ``timeout=`` — plus the streaming
knobs those surfaces never had: a compile-ahead ``window`` (how many
bundles the coordinator may hold pulled-but-unfinished, the backpressure
bound on the iterator-of-bundles pipeline) and ``autoscale`` /
``min_workers`` (grow the pool on queue depth, park it back at the floor
when the stream drains).

Everything validates at *construction*: a mesh on the thread executor,
hosts without the remote executor, ``agents=`` without a listener — all
fail loudly before any profile is generated, compiled, or shipped.  The
``thread()`` / ``process()`` / ``remote()`` constructors only expose the
knobs their executor understands, so misuse is an argument error rather
than a runtime surprise.  Configs are frozen and picklable, so one object
can parameterize a CLI invocation, travel in a job description, or be
compared in tests.

Migration (every surface accepts ``config=``)::

    # before (still works, folds into a FleetConfig + DeprecationWarning)
    em.emulate_many(profiles, executor="process", max_workers=8,
                    mesh_spec=MeshSpec(shape=(2,)), timeout=120.0)

    # after
    cfg = FleetConfig.process(max_workers=8, mesh=MeshSpec(shape=(2,)),
                              timeout=120.0)
    em.emulate_many(profiles, config=cfg)
    run_fleet(jobs, profiles=store.stream(tags), config=cfg)
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, fields
from typing import Dict, Optional, Sequence, Tuple

from repro_torch.core.emulator import UNSET, VALID_EXECUTORS, _Unset
from repro_torch.fleet.bundle import MeshSpec
from repro_torch.fleet.chaos import ChaosPolicy

#: legacy kwarg names the surfaces fold into a FleetConfig
LEGACY_FLEET_KWARGS = ("executor", "max_workers", "mesh_spec", "hosts",
                       "listen", "agents", "timeout")


@dataclass(frozen=True)
class FleetConfig:
    """Where and how a fleet replays: executor, pool shape, stream shape.

    ``window`` bounds the compile-ahead pipeline: the coordinator holds at
    most ``window`` bundles pulled from the profile source but not yet
    finished, blocking the source (and therefore compilation) when workers
    fall behind.  ``None`` picks ``2 × worker slots`` at run time, which
    keeps every slot fed while the queue-depth signal stays live.

    ``autoscale`` makes the pool elastic between ``min_workers`` (default
    1) and ``max_workers``: the scheduler spawns/invites capacity while
    queued bundles outnumber free slots and retires idle workers (or
    releases idle remote agents) once the stream drains.  Scale events and
    high-water marks surface in ``FleetReport.scaling``.

    The robustness knobs shape how the scheduler survives faults:
    ``max_attempts`` is the per-bundle dispatch budget before a bundle is
    declared poison; ``liveness_timeout`` arms heartbeat-based hung-peer
    detection (process/remote only — a peer silent that long is destroyed
    and its work requeued); ``speculate`` re-dispatches a straggling
    bundle once its age exceeds ``speculate × median`` completion time
    (first result wins); ``on_failure`` picks between failing the run on
    a poison bundle (``"raise"``) and completing degraded (``"skip"``,
    holes listed in ``FleetReport.recovery["skipped"]``); ``chaos``
    injects a seeded, reproducible fault schedule (process/remote only);
    ``max_respawns`` caps worker respawns (process only).  Fault accounting
    lands in ``FleetReport.recovery``.

    ``dag=True`` declares the run dependency-structured (bundles carry
    ``parents`` edges, or the profile source is a ``WorkloadDag``) and
    validates the combination up front: dependency edges need the
    frontier scheduler in ``FleetBase.stream``, so the thread executor
    is rejected at construction, and ``check_collect`` rejects
    ``collect="totals"`` — totals mode drops the per-node timing that
    critical-path accounting folds (and its index-order fold contract is
    what makes DAG totals bit-identical to the linear stream's).
    Passing a ``WorkloadDag`` to ``emulate_many`` applies the same
    checks even with ``dag=False`` — the flag exists so a config built
    far from the profile source still fails loudly at construction.
    """

    executor: str = "thread"
    max_workers: int = 4
    min_workers: Optional[int] = None        # autoscale floor (default 1)
    autoscale: bool = False
    window: Optional[int] = None             # compile-ahead bundles
    mesh_spec: Optional[MeshSpec] = None
    hosts: Optional[Tuple[str, ...]] = None
    listen: Optional[str] = None
    agents: Optional[int] = None
    timeout: float = 600.0
    max_attempts: int = 3                    # per-bundle dispatch budget
    liveness_timeout: Optional[float] = None  # hung-peer reap threshold
    on_failure: str = "raise"                # or "skip": complete degraded
    speculate: Optional[float] = None        # straggler re-dispatch factor
    chaos: Optional[ChaosPolicy] = None      # seeded fault injection
    max_respawns: Optional[int] = None       # process-pool respawn budget
    dag: bool = False                        # dependency-structured run

    def __post_init__(self):
        if self.executor not in VALID_EXECUTORS:
            raise ValueError(
                f"unknown executor {self.executor!r}; valid choices: "
                + ", ".join(repr(e) for e in VALID_EXECUTORS))
        if self.hosts is not None and not isinstance(self.hosts, tuple):
            object.__setattr__(self, "hosts", tuple(self.hosts))
        if self.max_workers < 1:
            raise ValueError("max_workers must be >= 1")
        if self.timeout < 0:
            raise ValueError("timeout must be >= 0")
        if self.window is not None and self.window < 1:
            raise ValueError("window must be >= 1 (it bounds compile-ahead "
                             "bundles in flight)")
        if self.executor != "remote" and (self.hosts is not None
                                          or self.listen is not None
                                          or self.agents is not None):
            raise ValueError("hosts/listen/agents configure "
                             "executor='remote' agents; they have no "
                             f"meaning for executor={self.executor!r}")
        if self.executor == "remote" and not self.hosts \
                and self.listen is None:
            raise ValueError("executor='remote' needs agents to schedule "
                             "on: pass hosts=[...] to dial listening agents "
                             "and/or listen='host:port' (+ agents=N) to "
                             "accept dial-in agents")
        if self.agents is not None and self.listen is None:
            raise ValueError("agents=N counts dial-in joins and needs "
                             "listen='host:port'")
        if self.mesh_spec is not None and self.executor == "thread":
            raise ValueError("mesh_spec requires executor='process' or "
                             "'remote': thread workers share one "
                             "process and cannot own per-worker meshes, so "
                             "the collective legs it asks for would be "
                             "silently dropped")
        if self.autoscale and self.executor == "thread":
            raise ValueError("autoscale requires executor='process' or "
                             "'remote': only those pools can spawn/retire "
                             "workers (threads are a fixed shared pool)")
        if self.min_workers is not None:
            if not self.autoscale:
                raise ValueError("min_workers is the autoscale floor; pass "
                                 "autoscale=True with it")
            if not 1 <= self.min_workers <= self.max_workers:
                raise ValueError(
                    f"min_workers={self.min_workers} must satisfy "
                    f"1 <= min_workers <= max_workers={self.max_workers}")
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1 (it is the "
                             "per-bundle dispatch budget)")
        if self.on_failure not in ("raise", "skip"):
            raise ValueError(f"on_failure must be 'raise' or 'skip', got "
                             f"{self.on_failure!r}")
        if self.liveness_timeout is not None and self.liveness_timeout <= 0:
            raise ValueError("liveness_timeout must be > 0 seconds")
        if self.speculate is not None and self.speculate < 1.0:
            raise ValueError("speculate must be >= 1.0 (it multiplies the "
                             "median bundle completion time)")
        if self.executor == "thread":
            for knob, val in (("liveness_timeout", self.liveness_timeout),
                              ("speculate", self.speculate),
                              ("chaos", self.chaos)):
                if val is not None:
                    raise ValueError(
                        f"{knob} requires executor='process' or 'remote': "
                        "thread workers share one process, so there is no "
                        "peer to heartbeat, kill, or re-dispatch against")
        if self.max_respawns is not None:
            if self.executor != "process":
                raise ValueError("max_respawns caps the local process "
                                 "pool's respawn budget; remote agents own "
                                 "their own (executor='process' only)")
            if self.max_respawns < 0:
                raise ValueError("max_respawns must be >= 0")
        if self.chaos is not None and not isinstance(self.chaos,
                                                     ChaosPolicy):
            raise TypeError(f"chaos must be a ChaosPolicy, got "
                            f"{type(self.chaos).__name__}")
        if self.dag and self.executor == "thread":
            raise ValueError(
                "dag=True requires executor='process' or 'remote': "
                "dependency edges are honored by the frontier scheduler "
                "in FleetBase.stream — the in-process thread pool has no "
                "dispatch gating, so edges would be silently ignored")

    def check_collect(self, collect: str, *, dag: Optional[bool] = None
                      ) -> None:
        """Validate a ``collect`` mode against this config (and, when the
        caller knows it, whether the profile source is actually a DAG).
        ``collect="totals"`` on a dependency-structured run is rejected:
        totals mode drops the per-node ``BundleTiming`` stamps that
        critical-path accounting needs."""
        effective = self.dag if dag is None else (dag or self.dag)
        if effective and collect == "totals":
            raise ValueError(
                "collect='totals' is incompatible with a "
                "dependency-structured run: totals mode drops the "
                "per-node BundleTiming stamps critical-path accounting "
                "needs — use collect='reports'")

    @property
    def scale_min(self) -> int:
        """Effective autoscale floor."""
        return self.min_workers if self.min_workers is not None else 1

    # -- fleet construction (the service's standing pool uses these) --------

    def worker_spec(self, emulator_spec, device: str = "cuda"
                    ) -> "WorkerSpec":
        """Build the ``WorkerSpec`` this config implies for one worker:
        the emulator's picklable recipe (``Emulator.spec()``), the device
        it replays on, the per-worker mesh, the chaos policy, and a
        heartbeat cadence derived from ``liveness_timeout`` (4 beats per
        window, floored at 100ms) exactly like ``run_process_fleet``
        does."""
        from repro_torch.fleet.bundle import WorkerSpec
        heartbeat = 0.0
        if self.liveness_timeout is not None:
            heartbeat = max(0.1, self.liveness_timeout / 4.0)
        return WorkerSpec(emulator=emulator_spec, mesh=self.mesh_spec,
                          heartbeat_s=heartbeat, chaos=self.chaos,
                          device=device)

    def build(self, spec: "WorkerSpec"):
        """Construct the live pool (``ProcessFleet`` / ``RemoteFleet``)
        this config describes.  Only those two executors *have* a standing
        pool to build — the thread path replays in-process and raises
        here.  The caller owns the returned fleet's lifecycle."""
        if self.executor == "process":
            from repro_torch.fleet.executor import ProcessFleet
            return ProcessFleet(self.max_workers, spec,
                                autoscale=self.autoscale,
                                min_workers=self.min_workers,
                                max_respawns=self.max_respawns)
        if self.executor == "remote":
            from repro_torch.fleet.transport.remote import RemoteFleet
            return RemoteFleet(spec, hosts=self.hosts, listen=self.listen,
                               agents=self.agents,
                               autoscale=self.autoscale,
                               min_workers=self.min_workers)
        raise ValueError(
            "only executor='process' or 'remote' can build a standing "
            f"worker pool; executor={self.executor!r} replays in-process")

    # -- constructors (each exposes only its executor's knobs) --------------

    @classmethod
    def thread(cls, max_workers: int = 4, *, window: Optional[int] = None,
               max_attempts: int = 3, on_failure: str = "raise",
               timeout: float = 600.0) -> "FleetConfig":
        """In-process thread pool: shared plan cache, no meshes, no
        elasticity — but the profile source is still pulled lazily with a
        ``window``-bounded submission queue."""
        return cls(executor="thread", max_workers=max_workers,
                   window=window, max_attempts=max_attempts,
                   on_failure=on_failure, timeout=timeout)

    @classmethod
    def process(cls, max_workers: int = 4, *,
                min_workers: Optional[int] = None, autoscale: bool = False,
                mesh: Optional[MeshSpec] = None,
                window: Optional[int] = None,
                max_attempts: int = 3,
                liveness_timeout: Optional[float] = None,
                on_failure: str = "raise",
                speculate: Optional[float] = None,
                chaos: Optional[ChaosPolicy] = None,
                max_respawns: Optional[int] = None,
                dag: bool = False,
                timeout: float = 600.0) -> "FleetConfig":
        """Spawn-based local worker pool
        (``repro_torch.fleet.ProcessFleet``)."""
        return cls(executor="process", max_workers=max_workers,
                   min_workers=min_workers, autoscale=autoscale,
                   mesh_spec=mesh, window=window,
                   max_attempts=max_attempts,
                   liveness_timeout=liveness_timeout, on_failure=on_failure,
                   speculate=speculate, chaos=chaos,
                   max_respawns=max_respawns, dag=dag, timeout=timeout)

    @classmethod
    def remote(cls, hosts: Optional[Sequence[str]] = None, *,
               listen: Optional[str] = None, agents: Optional[int] = None,
               mesh: Optional[MeshSpec] = None, autoscale: bool = False,
               min_workers: Optional[int] = None,
               window: Optional[int] = None,
               max_attempts: int = 3,
               liveness_timeout: Optional[float] = None,
               on_failure: str = "raise",
               speculate: Optional[float] = None,
               chaos: Optional[ChaosPolicy] = None,
               dag: bool = False,
               timeout: float = 600.0) -> "FleetConfig":
        """TCP host agents (``repro_torch.fleet.RemoteFleet``): dial
        ``hosts`` and/or ``listen`` for dial-in agents.  With ``autoscale``
        the open listener keeps inviting late joiners mid-run and idle
        agents are released once the stream drains (``min_workers`` agents
        are kept)."""
        return cls(executor="remote",
                   hosts=tuple(hosts) if hosts else None, listen=listen,
                   agents=agents, mesh_spec=mesh, autoscale=autoscale,
                   min_workers=min_workers, window=window,
                   max_attempts=max_attempts,
                   liveness_timeout=liveness_timeout, on_failure=on_failure,
                   speculate=speculate, chaos=chaos, dag=dag,
                   timeout=timeout)

    # -- legacy folding ------------------------------------------------------

    @classmethod
    def fold(cls, config: Optional["FleetConfig"], given: Dict,
             *, caller: str) -> "FleetConfig":
        """Resolve one call's fleet configuration.

        ``given`` holds only the legacy kwargs the caller explicitly
        passed.  ``config=`` and legacy kwargs are mutually exclusive;
        legacy kwargs keep working but fold into a ``FleetConfig`` under a
        ``DeprecationWarning``.  No config and no legacy kwargs means the
        defaults (thread pool of 4).
        """
        given = {k: v for k, v in given.items()
                 if v is not UNSET and not isinstance(v, _Unset)}
        unknown = set(given) - {f.name for f in fields(cls)}
        if unknown:
            raise TypeError(f"{caller}: unknown fleet kwarg(s) "
                            f"{sorted(unknown)}")
        if config is not None:
            if given:
                raise ValueError(
                    f"{caller} got both config= and legacy fleet kwarg(s) "
                    f"{sorted(given)}; pass one surface, not both")
            if not isinstance(config, cls):
                raise TypeError(f"{caller}: config must be a FleetConfig, "
                                f"got {type(config).__name__}")
            return config
        if not given:
            return cls()
        warnings.warn(
            f"{caller}: fleet kwarg(s) {sorted(given)} are deprecated; "
            "pass config=repro_torch.fleet.FleetConfig(...) (or its "
            ".thread()/.process()/.remote() constructors) instead",
            DeprecationWarning, stacklevel=3)
        return cls(**given)

"""Multi-host fleet: schedule bundles over TCP to host agents.

``RemoteFleet`` is the network instantiation of the transport-agnostic
scheduler in ``repro_torch.fleet.executor``: each peer is one framed
TCP connection (see ``framing``) to a host agent
(``python -m repro_torch.fleet.agent``) that fronts N worker processes on
its machine, each on the device the shipped ``WorkerSpec`` names.  The coordinator ships the ``WorkerSpec`` once per agent at
join time, then streams ``ScheduleBundle``s into the agent's free worker
slots and collects ``EmulationReport``s — the same attempt-budget,
poison-bundle, and worker-death semantics as ``ProcessFleet``, because
it *is* the same scheduler: a dead TCP peer is reaped like a dead
process, and its in-flight bundles requeue onto surviving agents.

Two join topologies, freely mixable:

  * **dial** — agents already listening (``agent --listen``), the
    coordinator connects out: ``RemoteFleet(spec, hosts=["h1:9000",
    "h2:9000"])``.
  * **accept** — the coordinator listens and agents dial in
    (``agent --connect host:port``): ``RemoteFleet(spec,
    listen="0.0.0.0:9000", agents=2)``.  The listener stays open during
    runs, so late agents join the pool mid-run — a reaped agent's work
    can drain onto a machine that wasn't there when the run started.

Wire messages (pickled frames; every run/reply carries the dispatch
epoch so a straggler reply from an aborted run can never be mistaken
for a live one):

  coordinator -> agent:  ("spec", WorkerSpec)
                         ("run", epoch, idx, ScheduleBundle[, t_sent])
                         ("stop",)
  agent -> coordinator:  ("ready", info)
                         ("ok", epoch, idx, EmulationReport[, ObsFrame])
                         ("retry", epoch, idx, reason)   requeue: an
                              agent-local worker died with this in flight
                         ("err", epoch, idx, traceback[, ObsFrame])
                              idx=None: the agent failed to initialize
                         ("obs", ObsFrame)  final buffer, shipped on stop

The optional trailing fields are the flight-recorder piggyback
(``repro_torch.obs``): a dispatch carries the coordinator's monotonic
stamp, and results ship the agent's drained event buffer (its own events plus
its local workers', already rebased to the agent clock) with that stamp
echoed — the coordinator folds the echo into a per-agent clock-offset
estimate and merges the events onto the run timeline.  Both arities are
accepted on both ends.
"""
from __future__ import annotations

import socket
import time
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.atoms import COLLECTIVE_TODO
from repro_torch.core.emulator import Emulator, FleetReport, ReportFold
from repro_torch.fleet.bundle import WorkerSpec, bundle_profile
from repro_torch.fleet.dag import critical_path
from repro_torch.fleet.executor import FleetBase, Peer, PeerGone
from repro_torch.fleet.transport import framing
from repro_torch.obs import clock as obs_clock

_IO_TIMEOUT = 60.0         # per-chunk socket deadline: a wedged peer is
                           # a dead peer, not a hung coordinator
_HANDSHAKE_TIMEOUT = 10.0  # dial: we initiated, give the agent room
# Accepts happen inline in the scheduler loop, so a stray TCP client that
# connects and says nothing stalls dispatch for the whole handshake
# window — keep it short: a real agent writes its 8-byte hello
# immediately after connecting.
_ACCEPT_HANDSHAKE_TIMEOUT = 2.0


def parse_addr(text: str) -> Tuple[str, int]:
    """``"host:port"`` (or bare ``"port"``) -> (host, port)."""
    host, _, port = str(text).rpartition(":")
    try:
        return host or "127.0.0.1", int(port)
    except ValueError:
        raise ValueError(f"bad address {text!r}: expected HOST:PORT") from None


class AgentPeer(Peer):
    """One connected host agent; capacity = its advertised worker count."""

    def __init__(self, sock: socket.socket, addr: Tuple[str, int]):
        super().__init__()
        self.sock = sock
        self.addr = addr
        self.capacity = 1          # grows when the ready info arrives
        self.scope = f"agent:{addr[0]}:{addr[1]}"
        self._named = False        # upgraded to the hostname on ready

    @property
    def waitable(self):
        return self.sock

    def dispatch(self, epoch, idx, bundle):
        try:
            framing.send_frame(self.sock,
                               ("run", epoch, idx, bundle,
                                obs_clock.now()))
        except framing.TransportError as e:
            raise PeerGone(str(e)) from e
        self.tasks.add((epoch, idx))

    def recv(self):
        try:
            msg = framing.recv_frame(self.sock)
        except framing.TransportError as e:
            # a corrupt stream (FramingError) is as unusable as a closed
            # one — either way this peer is done
            raise PeerGone(str(e)) from e
        kind = msg[0]
        if kind == "ping":
            return ("ping",)
        if kind == "ready":
            info = msg[1]
            self.capacity = max(1, int(info.get("workers", 1)))
            if not self._named and isinstance(info, dict) \
                    and info.get("host"):
                self.scope = f"agent:{info['host']}"
                self._named = True
            return ("ready", info)
        if kind in ("ok", "retry", "err", "obs"):
            return msg
        return ("err", None, None, f"unknown agent message {kind!r}")

    def stop(self):
        try:
            framing.send_frame(self.sock, ("stop",))
        except framing.TransportError:
            pass

    def drain_obs(self, timeout: float = 0.5):
        """Best-effort read of the final ``("obs", frame)`` a stopped
        agent ships on its way out; returns the frame or None."""
        try:
            self.sock.settimeout(timeout)
            while True:
                msg = framing.recv_frame(self.sock)
                if msg and msg[0] == "obs":
                    return msg[1]
                if msg and msg[0] not in ("ping",):
                    return None     # a late result: too late to use
        except (framing.TransportError, OSError):
            return None
        finally:
            try:
                self.sock.settimeout(_IO_TIMEOUT)
            except OSError:
                pass

    def close(self):
        try:
            self.sock.close()
        except OSError:
            pass

    def describe(self) -> str:
        return f"agent {self.addr[0]}:{self.addr[1]}"


class RemoteFleet(FleetBase):
    """A fleet of host agents reachable over TCP.

    Warm state like ``ProcessFleet``: agents join once (spawning and
    warming their local workers, each with its own CUDA context on the
    spec's device), then many ``run()``/``stream()`` calls reuse them.  ``worker_deaths`` counts reaped
    *agents*; ``n_workers`` is the fleet-wide worker-slot total.

    With ``autoscale=True`` the pool is elastic: the open listener keeps
    *inviting* capacity mid-run (a late joiner admitted after initial
    assembly counts as a scale-up), and once a stream's source drains,
    idle agents beyond the ``min_workers`` floor are *released* — sent the
    polite ``stop`` frame, so their worker pools exit instead of idling on
    another machine.
    """

    def __init__(self, spec: WorkerSpec, *,
                 hosts: Optional[Sequence[str]] = None,
                 listen: Optional[str] = None,
                 agents: Optional[int] = None,
                 connect_timeout: float = 30.0,
                 autoscale: bool = False,
                 min_workers: Optional[int] = None):
        super().__init__()
        if not hosts and listen is None:
            raise ValueError("RemoteFleet needs agents to schedule on: pass "
                             "hosts=[...] to dial listening agents and/or "
                             "listen='host:port' (+ agents=N) to accept "
                             "dial-in agents")
        if agents is not None and listen is None:
            raise ValueError("agents=N counts dial-in joins and needs "
                             "listen='host:port'")
        if min_workers is not None and not autoscale:
            raise ValueError("min_workers is the autoscale floor; pass "
                             "autoscale=True with it")
        if spec.mesh is not None:
            raise NotImplementedError(COLLECTIVE_TODO)
        self.spec = spec
        self._autoscale = autoscale
        self._scale_min = max(1, min_workers or 1)
        self._listener: Optional[socket.socket] = None
        self._min_agents = len(hosts or ())
        for addr in hosts or ():
            self._dial(parse_addr(addr), connect_timeout)
        if listen is not None:
            host, port = parse_addr(listen)
            self._listener = socket.create_server((host, port), backlog=16)
            self._min_agents += 1 if agents is None else agents

    # -- joining ------------------------------------------------------------

    @property
    def bound_addr(self) -> Optional[Tuple[str, int]]:
        """The listener's actual (host, port) — for ``listen='host:0'``."""
        if self._listener is None:
            return None
        addr = self._listener.getsockname()
        return addr[0], addr[1]

    @property
    def n_workers(self) -> int:
        return sum(p.capacity for p in self._peers)

    @property
    def n_agents(self) -> int:
        return len(self._peers)

    def _dial(self, addr: Tuple[str, int], timeout: float) -> None:
        sock = socket.create_connection(addr, timeout=timeout)
        self._join(sock, addr, _HANDSHAKE_TIMEOUT)

    def _join(self, sock: socket.socket, addr: Tuple[str, int],
              handshake_timeout: float) -> None:
        """Handshake + ship the WorkerSpec; the ready comes back later
        through the normal scheduler loop."""
        sock.settimeout(handshake_timeout)
        try:
            framing.handshake(sock)
            framing.send_frame(sock, ("spec", self.spec))
        except framing.TransportError:
            sock.close()
            raise
        sock.settimeout(_IO_TIMEOUT)
        self._peers.append(AgentPeer(sock, addr))

    def _handle_extra(self, obj) -> None:
        if obj is not self._listener:
            return
        try:
            sock, addr = self._listener.accept()
        except OSError:
            return
        try:
            self._join(sock, addr, _ACCEPT_HANDSHAKE_TIMEOUT)
        except framing.TransportError:
            # not a fleet agent (port scanner, wrong version): drop it,
            # keep listening — never take the fleet down
            return
        if self._min_agents == 0:
            # past initial assembly: this join is elastic capacity the
            # listener invited mid-run, i.e. a scale-up
            self.scale_ups += 1

    def _extra_waitables(self) -> List:
        return [self._listener] if self._listener is not None else []

    def _close_extras(self) -> None:
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
            self._listener = None

    # -- lifecycle ----------------------------------------------------------

    def _warming(self) -> bool:
        return (sum(1 for p in self._peers if p.ready) < self._min_agents
                or super()._warming())

    def warmup(self, timeout: float = 120.0) -> List[Dict]:
        infos = super().warmup(timeout)
        # the join gate is for *initial* fleet assembly only — once met,
        # later agent deaths are handled by reap/requeue, not by blocking
        # the next run on a replacement that may never come
        self._min_agents = 0
        return infos

    def _assemble(self, timeout: float) -> None:
        if self._min_agents:
            # initial assembly only: agents may still be dialing in, so
            # don't declare an empty pool dead before the join gate was
            # ever met.  Once assembled (_min_agents == 0), a late joiner
            # that is connected but still warming must NOT re-gate the
            # run — dispatches to it buffer in the socket, and the warm
            # agents keep draining meanwhile.
            self.warmup(timeout=min(timeout, 120.0))


def run_remote_fleet(emulator: Emulator, profiles, *,
                     hosts: Optional[Sequence[str]] = None,
                     listen: Optional[str] = None,
                     agents: Optional[int] = None, mesh_spec=None,
                     flops_scale: float = 1.0, storage_scale: float = 1.0,
                     mem_scale: float = 1.0, verify: bool = True,
                     timeout: float = 600.0,
                     fleet: Optional[RemoteFleet] = None,
                     window: Optional[int] = None, autoscale: bool = False,
                     min_workers: Optional[int] = None,
                     collect: str = "reports",
                     max_attempts: Optional[int] = None,
                     liveness_timeout: Optional[float] = None,
                     speculate: Optional[float] = None,
                     on_failure: str = "raise",
                     chaos=None) -> FleetReport:
    """Compile → detach → ship over TCP, streamed: one-call remote replay.

    Backs ``Emulator.emulate_many(executor="remote")``.  ``profiles`` may
    be any iterable — a lazy source is compiled as the scheduler pulls, at
    most ``window`` bundles ahead of dispatch, so coordinator memory is
    bounded by the window however long the stream runs.  Pass ``fleet`` to
    reuse a warm ``RemoteFleet`` (the caller keeps ownership; the spec —
    chaos policy included — is then the caller's); otherwise one is
    assembled from ``hosts``/``listen``/``agents`` and torn down around
    this run — tearing down tells the agents to exit, so one-shot runs
    don't leave orphaned worker pools on other machines.  The agents'
    workers replay on ``emulator.device``; ``mesh_spec`` raises
    ``NotImplementedError`` until the collective atom is ported.
    ``collect="totals"`` drops per-profile reports and returns
    index-order-folded aggregates only.

    Hardening: ``liveness_timeout`` arms hung-agent reaping (the shipped
    spec asks agents to heartbeat at a quarter of it), ``speculate``/
    ``max_attempts``/``on_failure`` pass through to ``stream``, and a
    seeded ``chaos`` policy travels in the spec so agents *and* their
    local workers inject the same deterministic fault schedule as a
    process fleet given the same policy.  Stats/scaling/recovery are
    snapshotted even when the stream raises — the partial ``FleetReport``
    rides on the exception as ``.fleet_report``.

    ``profiles`` may also be a ``WorkloadDag`` (anything with a
    ``parents_map``): node bundles ship their dependency edges, the
    scheduler's frontier gates dispatch on them across agents, and the
    report's ``dag`` dict carries critical-path accounting — same
    contract as ``run_process_fleet``, ``collect="totals"`` rejected.
    """
    if mesh_spec is not None:
        raise NotImplementedError(COLLECTIVE_TODO)
    is_dag = hasattr(profiles, "parents_map")
    if is_dag and collect == "totals":
        raise ValueError(
            "collect='totals' is incompatible with a WorkloadDag: totals "
            "mode drops the per-node BundleTiming stamps critical-path "
            "accounting needs — use collect='reports'")
    own = fleet is None
    if own:
        # assemble (and config-validate / dial) BEFORE compiling: a bad
        # hosts/listen config or unreachable agent should not cost a full
        # fleet's worth of trace/compile work first
        heartbeat_s = (max(0.1, liveness_timeout / 4.0)
                       if liveness_timeout else 0.0)
        fleet = RemoteFleet(WorkerSpec(emulator=emulator.spec(),
                                       mesh=mesh_spec,
                                       heartbeat_s=heartbeat_s,
                                       chaos=chaos,
                                       device=str(emulator.device)),
                            hosts=hosts, listen=listen, agents=agents,
                            autoscale=autoscale, min_workers=min_workers)
    t0 = time.perf_counter()
    fold = ReportFold(keep_reports=collect != "totals")
    n_samples = {"n": 0}                 # true profile samples compiled

    timings: Dict[int, "BundleTiming"] = {}

    def _bundles():
        if is_dag:
            for node in profiles.nodes:
                b = bundle_profile(emulator, node.profile,
                                   mesh_spec=mesh_spec,
                                   flops_scale=flops_scale,
                                   storage_scale=storage_scale,
                                   mem_scale=mem_scale, verify=verify,
                                   parents=node.parents)
                n_samples["n"] += b.n_profile_samples
                yield b
            return
        for p in profiles:
            b = bundle_profile(emulator, p, mesh_spec=mesh_spec,
                               flops_scale=flops_scale,
                               storage_scale=storage_scale,
                               mem_scale=mem_scale, verify=verify)
            n_samples["n"] += b.n_profile_samples
            yield b

    def _snapshot():
        return ({"agents": fleet.n_agents, "workers": fleet.n_workers,
                 "worker_deaths": fleet.worker_deaths},
                dict(fleet.last_scaling), dict(fleet.last_recovery),
                fleet.n_workers)

    def _report(stats, scaling, recovery, workers, last_n=None):
        return FleetReport(
            reports=fold.reports, wall_s=time.perf_counter() - t0,
            serial_s=fold.serial_s, max_workers=workers, cache_stats=stats,
            totals=fold.totals, n_samples=n_samples["n"],
            n_replayed=fold.n_done, scaling=scaling, recovery=recovery,
            obs=fleet.obs_snapshot(last_n),
            dag=(critical_path(profiles.parents_map, timings)
                 if is_dag else {}))

    gen = fleet.stream(_bundles(), timeout=timeout, window=window,
                       max_attempts=max_attempts,
                       liveness_timeout=liveness_timeout,
                       speculate=speculate, on_failure=on_failure,
                       record_timing=(timings.__setitem__
                                      if is_dag else None))
    try:
        for idx, rep in gen:
            if rep is None:
                # degraded-mode hole: cascade holes classified apart
                fold.skip(idx,
                          ancestor=idx in fleet.last_ancestor_skips)
            else:
                fold.add(idx, rep)
        snap = _snapshot()
    except BaseException as e:
        # close the generator first so its finally published this run's
        # scaling/recovery records, then let the partial report ride out
        # on the exception
        gen.close()
        # postmortem: the merged timeline's tail rides out on the raise
        e.fleet_report = _report(*_snapshot(), last_n=256)
        raise
    finally:
        if own:
            fleet.close()
    return _report(*snap)

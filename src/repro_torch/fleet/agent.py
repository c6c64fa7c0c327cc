"""Fleet host agent: lend this machine's workers to a remote coordinator.

    python -m repro_torch.fleet.agent --connect COORD_HOST:PORT --workers 4
    python -m repro_torch.fleet.agent --listen 0.0.0.0:9000     --workers 4

The agent is the host-side half of ``repro_torch.fleet.transport``: it
opens one framed TCP connection to a coordinator (dialing out with
``--connect``, or with ``--listen`` waiting for the coordinator to dial
in — print-and-flushes its bound address first, so launchers can scrape
the port when asked for ``:0``).  After the handshake it receives the
fleet's ``WorkerSpec``, spawns ``--workers`` local worker processes from
it (a plain ``ProcessFleet`` — same spawn path; each worker owns a CUDA
context on the device the spec names, and one asked for ``"cuda"`` on a
host without a card fails its init, which the agent reports to the
coordinator with the worker's traceback), reports ready with its
slot count, and then proxies: coordinator bundles are dispatched to idle
local workers, worker reports stream back tagged with the coordinator's
dispatch epoch.  The agent process itself imports the package (and so
torch) but touches no device and creates no CUDA context.

Local worker death is *not* hidden: the agent respawns within its budget
like any ``ProcessFleet``, but the orphaned bundle goes back to the
coordinator as a ``retry`` so the fleet-wide attempt/poison accounting
stays in one place.  If the agent runs out of live workers it returns
every queued bundle and exits; the coordinator reaps the closed
connection like a dead process worker.  The agent exits when the
coordinator says ``stop`` or its connection drops — it never outlives
the fleet it joined.

When the shipped ``WorkerSpec`` sets ``heartbeat_s``, the agent sends
``("ping",)`` frames from a daemon thread at that cadence — the
coordinator's liveness watermark.  (A *hung local worker* behind a live,
heartbeating agent is invisible to coordinator liveness; the agent's
ProcessFleet recovery is what covers that case.)  When the spec carries
a ``ChaosPolicy``, the agent derives the deterministic ``"agent"``-scope
actor and consults it per proxied result: it may mangle the Nth reply
frame (``corrupt_frame_nth`` — the coordinator reaps the corrupt stream)
or vanish instead of replying (``drop_agent_after``).  Its local workers
derive their own ``worker:<n>`` actors from the same policy, so a remote
fleet replays the same per-worker fault ordinals a process fleet would.
"""
from __future__ import annotations

import argparse
import os
import socket
import sys
import threading
import traceback
from collections import deque
from multiprocessing import connection as mp_conn
from typing import List, Optional

from repro_torch.fleet.transport import framing
from repro_torch.fleet.transport.remote import _IO_TIMEOUT, parse_addr
from repro_torch.obs import clock as obs_clock
from repro_torch.obs.recorder import FlightRecorder


def log(msg: str) -> None:
    print(f"[fleet-agent pid={os.getpid()}] {msg}", flush=True)


class _ChaosDrop(Exception):
    """Injected agent loss: close the coordinator connection abruptly."""


def serve(sock: socket.socket, n_workers: int) -> int:
    """Run the agent protocol on an established coordinator connection."""
    sock.settimeout(_IO_TIMEOUT)
    framing.handshake(sock)
    msg = framing.recv_frame(sock)
    if not (isinstance(msg, tuple) and msg and msg[0] == "spec"):
        raise framing.FramingError(
            f"expected a ('spec', WorkerSpec) frame first, got {msg!r}")
    spec = msg[1]
    from repro_torch.fleet.executor import PeerGone, ProcessFleet

    chaos = getattr(spec, "chaos", None)
    actor = chaos.actor("agent") if chaos is not None else None
    send_lock = threading.Lock()   # heartbeat thread vs serve loop: one
    hb_stop = threading.Event()    # frame on the wire at a time
    # the agent's own flight recorder: local worker frames are absorbed
    # (rebased through the per-worker clock sync) and re-shipped to the
    # coordinator on each proxied result, so remote worker events reach
    # the merged timeline through two offset estimations, not one guess
    recorder = FlightRecorder("agent", capacity=2048)

    def absorb_local(peer, frame) -> None:
        if frame is None:
            return
        t_recv = obs_clock.now()
        if frame.echo_t is not None:
            peer.sync.observe(frame.echo_t, frame.sent_at, t_recv)
        recorder.absorb(frame,
                        peer.sync.to_local if peer.sync.synced else None)

    def send(msg, *, _mangle=None) -> None:
        with send_lock:
            framing.send_frame(sock, msg, _mangle=_mangle)

    def send_result(msg) -> None:
        """ok/err results pass through the chaos actor on their way out."""
        if actor is not None:
            act = actor.on_reply()
            if act == "drop":
                log(f"chaos: dropping connection instead of result "
                    f"#{actor.replies}")
                raise _ChaosDrop()
            if act == "corrupt":
                log(f"chaos: corrupting result frame #{actor.replies}")
                send(msg, _mangle=chaos.corrupt_bytes)
                return
        send(msg)

    log(f"spawning {n_workers} local worker(s) on {spec.device}")
    try:
        fleet = ProcessFleet(n_workers, spec)
        infos = fleet.warmup()
    except BaseException:
        send(("err", None, None, traceback.format_exc()))
        raise
    send(("ready", {
        "workers": len(fleet.pids), "host": socket.gethostname(),
        "agent_pid": os.getpid(), "worker_infos": infos}))
    log(f"ready: {len(fleet.pids)} worker(s) warm on "
        f"{sorted({str(i.get('device')) for i in infos})}, serving")
    heartbeat_s = getattr(spec, "heartbeat_s", 0.0) or 0.0
    if heartbeat_s > 0:
        def _beat():
            # first beat fires immediately (same contract as the process
            # worker's sender): even a short-lived agent registers a pulse
            while True:
                try:
                    send(("ping",))
                except (framing.TransportError, OSError):
                    return
                if hb_stop.wait(heartbeat_s):
                    return
        threading.Thread(target=_beat, daemon=True,
                         name="agent-heartbeat").start()

    pending = deque()          # (epoch, idx, bundle) awaiting a free worker
    stopping = False
    served = 0

    def reap_local(peer):
        """A local worker died: hand its orphaned bundles back (the
        coordinator owns the attempt budget, so a bundle that kills
        workers is *its* poison call, not something to retry here), reap
        and maybe respawn, and re-advertise the slot count — if the
        respawn budget is spent the pool shrank for good, and the
        coordinator must stop filling slots this host no longer has."""
        for e, idx in list(peer.tasks):
            recorder.record("requeue", idx=idx,
                            reason="agent-local worker died")
            send(("retry", e, idx, "agent-local worker died"))
        peer.tasks.clear()
        fleet._reap(peer, deque())
        if fleet._peers or fleet._pending_refill():
            send(("ready", {"workers": max(1, len(fleet._peers))}))

    try:
        while True:
            in_flight = any(p.tasks for p in fleet._peers)
            if stopping and not in_flight and not pending:
                break
            fleet._tick(deque())   # service due backoff respawns
            # -- collect: coordinator frames + local worker replies -------
            waitables = ([] if stopping else [sock]) + \
                [p.waitable for p in fleet._peers]
            for obj in mp_conn.wait(waitables, timeout=0.5):
                if obj is sock:
                    msg = framing.recv_frame(sock)
                    if msg[0] == "stop":
                        stopping = True
                    elif msg[0] == "run":
                        epoch, idx, bundle = msg[1], msg[2], msg[3]
                        if len(msg) > 4:     # coordinator clock echo
                            recorder.last_echo = msg[4]
                        pending.append((epoch, idx, bundle))
                    continue
                peer = next(p for p in fleet._peers if p.waitable is obj)
                try:
                    reply = peer.recv()
                except PeerGone:
                    reap_local(peer)
                    continue
                kind = reply[0]
                if kind == "ready":
                    peer.ready = True          # a respawned replacement
                elif kind == "obs":
                    absorb_local(peer, reply[1])
                elif kind == "ok":
                    e, idx, rep = reply[1], reply[2], reply[3]
                    absorb_local(peer,
                                 reply[4] if len(reply) > 4 else None)
                    peer.tasks.discard((e, idx))
                    served += 1
                    send_result(("ok", e, idx, rep, recorder.drain()))
                elif kind == "err":
                    e, idx, tb = reply[1], reply[2], reply[3]
                    if idx is None:            # replacement failed init
                        reap_local(peer)
                    else:
                        absorb_local(peer,
                                     reply[4] if len(reply) > 4 else None)
                        peer.tasks.discard((e, idx))
                        send_result(("err", e, idx, tb, recorder.drain()))
                # "ping" from a local worker: nothing to proxy — the
                # agent's own heartbeat is the coordinator-facing signal
            # -- dispatch queued bundles to free local slots --------------
            for peer in list(fleet._peers):
                while pending and peer.free_slots > 0:
                    if not peer.alive:
                        reap_local(peer)
                        break
                    epoch, idx, bundle = pending.popleft()
                    try:
                        peer.dispatch(epoch, idx, bundle)
                    except PeerGone:
                        pending.appendleft((epoch, idx, bundle))
                        reap_local(peer)
                        break
                    recorder.record("dispatch", idx=idx, peer=peer.scope)
            if not fleet._peers and not fleet._pending_refill():
                for epoch, idx, _ in pending:
                    send(("retry", epoch, idx,
                          "agent has no live workers"))
                pending.clear()
                log("no live workers left and respawn budget spent — "
                    "leaving the fleet")
                return 1
    except framing.TransportClosed:
        log("coordinator connection closed — shutting down")
    except _ChaosDrop:
        try:
            sock.close()
        except OSError:
            pass
        log("chaos: agent dropped out of the fleet")
        return 3
    finally:
        hb_stop.set()
        try:
            # ship whatever the recorder still holds (events since the
            # last proxied result) before leaving the fleet
            send(("obs", recorder.drain()))
        except Exception:  # noqa: BLE001 — exit path, connection may be gone
            pass
        fleet.close()
    log(f"served {served} bundle(s), exiting")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.fleet.agent",
        description="Join this machine's emulator workers to a remote "
                    "fleet coordinator (see repro_torch.fleet.transport)")
    how = ap.add_mutually_exclusive_group(required=True)
    how.add_argument("--connect", metavar="HOST:PORT",
                     help="dial a coordinator listening at HOST:PORT")
    how.add_argument("--listen", metavar="HOST:PORT",
                     help="listen at HOST:PORT (port 0 for ephemeral; the "
                          "bound address is printed) and wait for one "
                          "coordinator to dial in")
    ap.add_argument("--workers", type=int, default=1, metavar="N",
                    help="local worker processes to offer (default 1)")
    ap.add_argument("--connect-timeout", type=float, default=30.0,
                    metavar="S", help="dial timeout (default 30s)")
    args = ap.parse_args(argv)
    if args.workers < 1:
        ap.error("--workers must be >= 1")

    if args.connect:
        addr = parse_addr(args.connect)
        log(f"connecting to coordinator {addr[0]}:{addr[1]}")
        sock = socket.create_connection(addr, timeout=args.connect_timeout)
    else:
        host, port = parse_addr(args.listen)
        srv = socket.create_server((host, port), backlog=1)
        bound = srv.getsockname()
        # scrapeable by launchers (and tests) that asked for port 0
        log(f"listening on {bound[0]}:{bound[1]}")
        sock, peer = srv.accept()
        srv.close()
        log(f"coordinator connected from {peer[0]}:{peer[1]}")
    try:
        return serve(sock, args.workers)
    except framing.TransportError as e:
        log(f"transport failed: {e}")
        return 1
    finally:
        try:
            sock.close()
        except OSError:
            pass


if __name__ == "__main__":
    sys.exit(main())

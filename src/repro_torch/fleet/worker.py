"""Fleet worker process: build an emulator once, replay bundles forever.

Spawned (never forked — a forked child would inherit the parent's CUDA
context, which CUDA forbids) by ``repro_torch.fleet.executor.ProcessFleet``
with one end of a pipe and a ``WorkerSpec``.  Module-level imports stay
light so worker start-up cost is dominated by exactly one thing: the
child's own torch import and CUDA context, which it pays once per
*worker*, not once per bundle — the whole point of shipping detached
schedules.  The worker runs on the device its spec names; asked for
``"cuda"`` where there is no card, it fails to initialize rather than
replay on the CPU.

Protocol (pickled tuples over the pipe):

  parent -> worker:  ("run", idx, ScheduleBundle[, t_sent]) | ("stop",)
  worker -> parent:  ("ready", info_dict)
                     ("ok", idx, EmulationReport[, ObsFrame])
                     ("err", idx | None, traceback_str[, ObsFrame])
                     ("ping",)   heartbeat, sent every ``heartbeat_s``
                                 from a daemon thread when the spec asks
                     ("obs", ObsFrame)   final buffer, shipped on stop

The optional trailing fields are the flight-recorder piggyback
(``repro_torch.obs``): dispatches carry the coordinator's clock stamp, and
every result ships the worker's drained event buffer home with that
stamp echoed, so the coordinator can estimate this worker's clock
offset and merge its events onto one timeline.  Both arities are
accepted on both ends — test fakes and older tooling speak the bare
tuples unchanged.

A bundle that fails to replay sends ``err`` and the worker keeps serving
(the parent decides whether to abort); a failure during initialization
sends ``err`` with ``idx=None`` and exits.

When the spec carries a ``ChaosPolicy``, the worker derives a
deterministic fault actor from its spawn ``scope`` (``"worker:<n>"``)
and consults it before replaying each bundle: it may die without
replying (``kill``), go silent with the pipe open and heartbeats paused
(``hang`` — the failure only heartbeat liveness can see), reply an
injected ``err`` (``fail``), or straggle (``delay``) before serving
normally.  All sends go through one lock so the heartbeat thread and
the serve loop never interleave a pickle mid-frame.
"""
from __future__ import annotations

import os
import threading
import time
import traceback


def _init(spec):
    """Build this worker's emulator on the spec's device; returns
    (emulator, info dict for the ready message)."""
    import numpy as np
    import torch

    from repro_torch.core.atoms import PlanCache
    from repro_torch.core.schedule import FusedSegment

    # a mesh is rejected before any spawn; only the device is the spec's
    em = spec.emulator.build(device=spec.device)
    # one plan cache per worker process: barrier-step plans (storage,
    # odd-sized legs) dedup across every bundle this worker will ever
    # replay
    em.set_plan_cache(PlanCache())
    if spec.warmup:
        # run the most common fused segment shape (1-row table, both
        # carries) once so the first real bundle doesn't pay for it
        em._segments.run(FusedSegment(
            table=np.asarray([[1, 1, 0]], dtype=np.int32), rows=[]))
    return em, {"pid": os.getpid(),
                "device": (torch.cuda.get_device_name(em.device)
                           if em.device.type == "cuda" else "cpu"),
                "devices": torch.cuda.device_count(), "mesh": None,
                "warm": bool(spec.warmup)}


def worker_loop(conn, spec, scope: str = "worker:0") -> None:
    """Process entry point: initialize, announce readiness, serve bundles."""
    from repro_torch.obs.recorder import FlightRecorder

    chaos = getattr(spec, "chaos", None)
    actor = chaos.actor(scope) if chaos is not None else None
    # this worker's flight recorder: drained onto every reply, so the
    # coordinator's timeline grows worker-side events (replays,
    # collective legs) as results land — a kill loses only the events
    # since the last reply, which is exactly what a crash should cost
    recorder = FlightRecorder(scope, capacity=2048)
    if actor is not None and chaos.kill_on_init:
        # the crash-loop test vector: a spec that can never come up.
        # Die before the (expensive) emulator build so the breaker is
        # exercised at spawn cadence, not torch-import cadence.
        conn.close()
        os._exit(13)
    try:
        em, info = _init(spec)
    except BaseException:  # noqa: BLE001 — report init failure, then die
        try:
            conn.send(("err", None, traceback.format_exc()))
        finally:
            conn.close()
        return
    send_lock = threading.Lock()
    hb_stop = threading.Event()
    hb_pause = threading.Event()

    def send(msg) -> None:
        with send_lock:
            conn.send(msg)

    send(("ready", info))
    heartbeat_s = getattr(spec, "heartbeat_s", 0.0)
    if heartbeat_s and heartbeat_s > 0:
        def _beat():
            # first beat fires immediately: a worker whose whole useful
            # life fits inside one interval still registers a pulse
            while True:
                if not hb_pause.is_set():  # hung workers don't heartbeat
                    try:
                        send(("ping",))
                    except (BrokenPipeError, OSError):
                        return
                if hb_stop.wait(heartbeat_s):
                    return
        threading.Thread(target=_beat, daemon=True,
                         name="fleet-heartbeat").start()
    try:
        while True:
            try:
                msg = conn.recv()
            except EOFError:          # parent died: nothing left to serve
                break
            if msg[0] == "stop":
                try:
                    send(("obs", recorder.drain()))
                except (BrokenPipeError, OSError):
                    pass
                break
            if msg[0] != "run":
                send(("err", None, f"unknown message {msg[0]!r}"))
                continue
            idx, bundle = msg[1], msg[2]
            if len(msg) > 3:            # coordinator clock echo
                recorder.last_echo = msg[3]
            if actor is not None:
                action = actor.on_dispatch()
                if action == "kill":
                    # die mid-bundle, before replying: the coordinator
                    # must notice the dead pipe, requeue idx, and charge
                    # the attempt budget
                    conn.close()
                    os._exit(17)
                if action == "fail":
                    send(("err", idx,
                          f"chaos: injected failure ({scope}, "
                          f"dispatch {actor.dispatches})",
                          recorder.drain()))
                    continue
                if isinstance(action, tuple):
                    what, seconds = action
                    if what == "hang":
                        # silent with the pipe open: no reply, no
                        # heartbeat — only the liveness watermark can
                        # tell this apart from a long bundle
                        hb_pause.set()
                        time.sleep(seconds)
                        hb_pause.clear()
                    elif what == "delay":
                        time.sleep(seconds)   # straggler: serve, but late
            try:
                rep = em.replay(bundle.rehydrate(),
                                command=bundle.command,
                                planned=bundle.planned,
                                flops_scale=bundle.flops_scale,
                                storage_scale=bundle.storage_scale,
                                mem_scale=bundle.mem_scale,
                                verify=bundle.verify)
            except BaseException:  # noqa: BLE001 — bad bundle, worker lives
                try:
                    send(("err", idx, traceback.format_exc(),
                          recorder.drain()))
                except (BrokenPipeError, OSError):
                    break             # parent reaped us mid-hang: done
                continue
            recorder.record("segment_replay", idx=idx, ttc_s=rep.ttc_s,
                            n_dispatches=rep.n_dispatches,
                            mode=rep.mode, n_samples=rep.n_samples)
            if rep.n_collective_dispatches:
                # a "collective_group" tag names the logical collective
                # this bundle's legs belong to — the trace exporter links
                # same-group legs across workers with flow arrows
                group = bundle.tags.get("collective_group")
                if group is not None:
                    recorder.record("collective_leg", idx=idx,
                                    n=rep.n_collective_dispatches,
                                    ici_bytes=rep.emulated_ici_bytes,
                                    group=group)
                else:
                    recorder.record("collective_leg", idx=idx,
                                    n=rep.n_collective_dispatches,
                                    ici_bytes=rep.emulated_ici_bytes)
            try:
                send(("ok", idx, rep, recorder.drain()))
            except (BrokenPipeError, OSError):
                break                 # parent reaped us mid-hang: done
    finally:
        hb_stop.set()
        em.storage.cleanup()
        conn.close()

"""Scenario CLI: drive the scenario engine from the command line.

    python -m repro_torch.scenarios list
    python -m repro_torch.scenarios run training_scan -p n_steps=6 \
        -p ckpt_every=3
    python -m repro_torch.scenarios fleet training_scan:n_steps=6 \
        serving_traffic --executor process --workers 2
    python -m repro_torch.scenarios fleet --store runs/ \
        --from-store scenario=x --executor remote --host host1:9000 \
        --host host2:9000
    python -m repro_torch.scenarios serve --port 8787
    python -m repro_torch.scenarios trace training_scan:n_steps=4 \
        --repeat 8 --workers 2 --kill-every 5 --out /tmp/fleet_trace.json

``list`` shows every registered generator with its defaults; ``run`` pushes
one scenario through generate -> predict -> emulate (-> store with
``--store``); ``fleet`` replays a batch concurrently, with ``--executor``
selecting the in-process thread pool, the process-level fleet executor
(``repro_torch.fleet``), or a remote fleet of host agents over TCP
(``--host`` dials listening ``python -m repro_torch.fleet.agent``
processes; ``--listen`` + ``--agents`` accepts dial-in ones).  ``--mesh N``
exits naming the ROADMAP item that ports the collective atom.
``--from-store`` turns ``--store`` into a profile *source*: matching
stored profiles are streamed into the fleet alongside (or instead of)
generated jobs.  ``serve`` starts the live traffic emulation service
(:mod:`repro_torch.service.http`): open-loop load runs against a standing
fleet, driven and reported over HTTP.  ``trace`` replays a (optionally
chaos-injected) batch on a process fleet with the flight recorder on
and writes the merged timeline as Chrome trace-event JSON — open the
file at https://ui.perfetto.dev (or ``chrome://tracing``) to see queue/
replay spans per worker and fault/scale instants.  ``--window 1`` (the
default there) serializes dispatch, so a seeded chaos run produces the
same event sequence every time.

``run``, ``fleet``, ``serve`` and ``trace`` emulate on ``--device``
(``cuda`` unless told otherwise; workers and agents' workers too).
Asking for ``cuda`` on a host without a card exits non-zero and names
the missing device; ``--device cpu`` runs on the host.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional, Tuple

from repro_torch.core.atoms import COLLECTIVE_TODO
from repro_torch.device import cli_device

PROG = "python -m repro_torch.scenarios"


def _coerce(text: str):
    """CLI param values: int -> float -> bool -> str, first parse wins."""
    for cast in (int, float):
        try:
            return cast(text)
        except ValueError:
            pass
    if text.lower() in ("true", "false"):
        return text.lower() == "true"
    return text


def _parse_params(pairs: List[str]) -> Dict:
    params = {}
    for pair in pairs:
        if "=" not in pair:
            raise SystemExit(f"bad -p {pair!r}: expected key=value")
        k, v = pair.split("=", 1)
        params[k.strip()] = _coerce(v.strip())
    return params


def _parse_job(text: str) -> Tuple[str, Dict]:
    """``name`` or ``name:k=v,k=v`` -> (name, params)."""
    name, _, rest = text.partition(":")
    params = _parse_params(rest.split(",")) if rest else {}
    return name.strip(), params


def _cmd_list(args) -> int:
    from repro_torch.scenarios import get_scenario, list_scenarios
    for name in list_scenarios():
        spec = get_scenario(name)
        print(f"{name:20s} {spec.description}")
        defaults = ", ".join(f"{k}={v}" for k, v in spec.defaults.items())
        print(f"{'':20s}   defaults: {defaults}")
    return 0


def _store(path: Optional[str]):
    if path is None:
        return None
    from repro_torch.core import ProfileStore
    return ProfileStore(path)


def _emulator(args):
    """The emulator on ``--device``; exits naming the device if it is
    missing (the port never falls back to the CPU on its own)."""
    from repro_torch.core.emulator import Emulator
    return Emulator(device=cli_device(args.device, PROG))


def _cmd_run(args) -> int:
    from repro_torch.scenarios import run_scenario
    params = _parse_params(args.param)
    res = run_scenario(args.name, store=_store(args.store),
                       emulator=None if args.no_emulate else _emulator(args),
                       emulate=not args.no_emulate,
                       fused=not args.per_sample, **params)
    out = res.summary()
    if res.report is not None:
        out["report"] = res.report.summary()
    if args.json:
        print(json.dumps(out, indent=2, default=str))
        return 0
    print(f"scenario {res.name}: {len(res.profile.samples)} samples, "
          f"{res.profile.totals.flops / 1e9:.3f} GFLOP")
    for hw, row in res.predictions.items():
        print(f"  predicted on {hw:18s} ttc_max={row['ttc_max']:.3e}s "
              f"dominant={row['dominant_total']}")
    if res.report is not None:
        r = res.report
        print(f"  emulated here: ttc={r.ttc_s:.3f}s mode={r.mode} "
              f"dispatches={r.n_dispatches}")
    if res.run_id is not None:
        print(f"  stored as {res.run_id}")
    return 0


def _cmd_fleet(args) -> int:
    from repro_torch.fleet import FleetConfig
    from repro_torch.scenarios import run_fleet
    config = FleetConfig(executor=args.executor, max_workers=args.workers,
                         hosts=args.host or None,
                         listen=args.listen, agents=args.agents,
                         timeout=args.timeout, window=args.window,
                         autoscale=args.autoscale is not None,
                         min_workers=args.autoscale,
                         max_attempts=args.max_attempts,
                         liveness_timeout=args.liveness,
                         on_failure=args.on_failure)
    jobs = [_parse_job(j) for j in args.job]
    store = _store(args.store)
    profiles = None
    if args.from_store is not None:
        # _parse_params coercion (int -> float -> bool -> str) matches the
        # JSON types tag values round-trip through the store with
        tags = _parse_params(args.from_store.split(",")) \
            if args.from_store else {}
        profiles = store.stream(tags)
    out = run_fleet(jobs, profiles=profiles, store=store, config=config,
                    emulator=_emulator(args), fused=not args.per_sample)
    f = out.fleet
    if args.json:
        print(json.dumps({"fleet": f.summary(),
                          "reports": [r.report.summary()
                                      for r in out.results]},
                         indent=2, default=str))
        return 0
    print(f"fleet: {f.n_profiles} profiles on {f.max_workers} "
          f"{args.executor} worker(s) in {f.wall_s:.3f}s "
          f"(per-profile TTCs sum to {f.serial_s:.3f}s)")
    for r in out.results:
        rep = r.report
        coll = (f" collective_dispatches={rep.n_collective_dispatches}"
                if rep.n_collective_dispatches else "")
        print(f"  {r.name:20s} ttc={rep.ttc_s:.3f}s mode={rep.mode}"
              f" dispatches={rep.n_dispatches}{coll}")
    if f.scaling:
        print("  scaling:", ", ".join(f"{k}={v}"
                                      for k, v in f.scaling.items()))
    if f.recovery:
        print("  recovery:", ", ".join(f"{k}={v}"
                                       for k, v in f.recovery.items()))
    extra = {k: v for k, v in f.cache_stats.items()}
    if extra:
        print("  stats:", ", ".join(f"{k}={v}" for k, v in extra.items()))
    return 0


def _cmd_serve(args) -> int:
    from repro_torch.service.http import serve
    serve(args.serve_host, args.port, emulator=_emulator(args))
    return 0


def _cmd_trace(args) -> int:
    from repro_torch.fleet import FleetConfig
    from repro_torch.fleet.chaos import ChaosPolicy
    from repro_torch.obs.recorder import Event, event_sequence
    from repro_torch.obs.trace import to_chrome_trace, write_trace
    from repro_torch.scenarios import run_fleet

    chaos_knobs = {k: v for k, v in (
        ("kill_every", args.kill_every), ("hang_nth", args.hang_nth),
        ("fail_nth", args.fail_nth)) if v}
    chaos = ChaosPolicy(seed=args.chaos_seed, max_faults=args.max_faults,
                        **chaos_knobs) if chaos_knobs else None
    config = FleetConfig.process(
        max_workers=args.workers, window=args.window, chaos=chaos,
        liveness_timeout=5.0 if chaos is not None else None,
        on_failure="skip",             # a poison job must still trace
        max_respawns=max(8, args.workers * 4), timeout=args.timeout)
    jobs = [_parse_job(j) for j in args.job] * args.repeat
    out = run_fleet(jobs, config=config, emulator=_emulator(args),
                    collect="totals")
    obs = out.fleet.obs
    events = [Event.from_dict(d) for d in obs.get("events", ())]
    trace = to_chrome_trace(events, meta={
        "jobs": args.job, "repeat": args.repeat, "workers": args.workers,
        "window": args.window, "chaos": repr(chaos),
        "dropped_events": obs.get("dropped_events", 0)})
    write_trace(args.out, trace)
    seq = event_sequence(events)
    rec = out.fleet.recovery
    print(f"trace: {len(events)} events ({len(seq)} in the deterministic "
          f"sequence), {obs.get('dropped_events', 0)} dropped")
    if rec:
        print("recovery:", ", ".join(f"{k}={v}" for k, v in rec.items()
                                     if k != "fault_events"))
    print(f"wrote {args.out} — open it at https://ui.perfetto.dev")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog=PROG,
        description="Synapse scenario engine CLI")
    sub = ap.add_subparsers(dest="cmd", required=True)

    sub.add_parser("list", help="list registered scenarios")

    run_p = sub.add_parser("run", help="run one scenario end-to-end")
    run_p.add_argument("name")
    run_p.add_argument("-p", "--param", action="append", default=[],
                       metavar="KEY=VALUE", help="scenario parameter")
    run_p.add_argument("--store", default=None, help="ProfileStore directory")
    run_p.add_argument("--no-emulate", action="store_true",
                       help="generate + predict only")
    run_p.add_argument("--per-sample", action="store_true",
                       help="force the legacy per-sample replay path")
    run_p.add_argument("--json", action="store_true")

    fl = sub.add_parser("fleet", help="replay a batch of scenarios")
    fl.add_argument("job", nargs="*",
                    metavar="NAME[:k=v,k=v]", help="scenario job spec")
    fl.add_argument("--executor", choices=("thread", "process", "remote"),
                    default="thread")
    fl.add_argument("--workers", type=int, default=4)
    fl.add_argument("--mesh", type=int, default=0, metavar="N",
                    help="give each process/remote worker an N-device mesh "
                         "(not ported yet: exits naming its ROADMAP item)")
    fl.add_argument("--per-sample", action="store_true",
                    help="force the legacy per-sample replay path "
                         "(thread executor only)")
    fl.add_argument("--window", type=int, default=None, metavar="N",
                    help="compile-ahead window: the coordinator holds at "
                         "most N profiles/bundles pulled-but-unfinished, "
                         "backpressuring the source (default: 2x workers)")
    fl.add_argument("--autoscale", type=int, default=None, metavar="MIN",
                    help="make the process/remote pool elastic: start at "
                         "MIN workers, grow to --workers on queue depth, "
                         "retire idle capacity when the stream drains")
    fl.add_argument("--timeout", type=float, default=600.0, metavar="S",
                    help="abort the fleet replay after S seconds "
                         "(default 600)")
    fl.add_argument("--max-attempts", type=int, default=3, metavar="N",
                    help="per-profile dispatch budget before it is "
                         "declared poison (default 3)")
    fl.add_argument("--liveness", type=float, default=None, metavar="S",
                    help="reap a worker/agent silent for S seconds and "
                         "requeue its profiles (process/remote; arms "
                         "heartbeats)")
    fl.add_argument("--on-failure", choices=("raise", "skip"),
                    default="raise",
                    help="poison profile handling: fail the run (raise, "
                         "default) or complete degraded with the holes "
                         "listed under recovery (skip)")
    fl.add_argument("--host", action="append", default=[],
                    metavar="HOST:PORT",
                    help="dial a remote agent listening at HOST:PORT "
                         "(repeatable; remote executor only)")
    fl.add_argument("--listen", default=None, metavar="HOST:PORT",
                    help="listen at HOST:PORT for dial-in remote agents "
                         "(remote executor only)")
    fl.add_argument("--agents", type=int, default=None, metavar="N",
                    help="with --listen: wait for N agents to join "
                         "before replaying")
    fl.add_argument("--store", default=None, help="ProfileStore directory")
    fl.add_argument("--from-store", default=None, nargs="?", const="",
                    metavar="TAGS",
                    help="stream profiles matching TAGS (k=v,k=v; empty "
                         "for all) out of --store into the fleet")
    fl.add_argument("--json", action="store_true")

    tr = sub.add_parser("trace",
                        help="replay a batch with the flight recorder on "
                             "and export a Perfetto-loadable trace")
    tr.add_argument("job", nargs="+", metavar="NAME[:k=v,k=v]",
                    help="scenario job spec (repeatable)")
    tr.add_argument("--repeat", type=int, default=1, metavar="N",
                    help="replay the job list N times (default 1)")
    tr.add_argument("--workers", type=int, default=2)
    tr.add_argument("--window", type=int, default=1, metavar="N",
                    help="compile-ahead window (default 1: dispatch is "
                         "serialized, so a seeded chaos run emits a "
                         "deterministic event sequence)")
    tr.add_argument("--kill-every", type=int, default=0, metavar="N",
                    help="chaos: kill a worker on its every-Nth dispatch")
    tr.add_argument("--hang-nth", type=int, default=0, metavar="N",
                    help="chaos: hang a worker on its Nth dispatch")
    tr.add_argument("--fail-nth", type=int, default=0, metavar="N",
                    help="chaos: inject a failure on the Nth dispatch")
    tr.add_argument("--max-faults", type=int, default=0, metavar="N",
                    help="cap injected faults per worker (0 = unlimited)")
    tr.add_argument("--chaos-seed", type=int, default=0)
    tr.add_argument("--timeout", type=float, default=600.0, metavar="S")
    tr.add_argument("--out", default="fleet_trace.json", metavar="PATH",
                    help="trace file to write (default fleet_trace.json)")

    sv = sub.add_parser("serve",
                        help="start the live traffic emulation service "
                             "(open-loop load runs over HTTP)")
    sv.add_argument("--host", dest="serve_host", default="127.0.0.1")
    sv.add_argument("--port", type=int, default=8787,
                    help="0 picks a free port (printed at startup)")

    for p in (run_p, fl, tr, sv):
        p.add_argument("--device", default="cuda",
                       help="device to emulate on (default cuda; cpu runs "
                            "on the host)")

    args = ap.parse_args(argv)
    if args.cmd == "fleet":
        if args.mesh and args.executor == "thread":
            ap.error("--mesh requires --executor process or remote "
                     "(threads cannot own per-worker meshes)")
        if args.mesh:
            ap.error(COLLECTIVE_TODO)
        if args.per_sample and args.executor != "thread":
            ap.error(f"--per-sample is incompatible with --executor "
                     f"{args.executor}: process/remote fleets ship "
                     "compiled (fused) schedules")
        if args.autoscale is not None and args.executor == "thread":
            ap.error("--autoscale requires --executor process or remote "
                     "(the thread pool is fixed-size)")
        if args.autoscale is not None and args.autoscale < 1:
            ap.error("--autoscale MIN must be >= 1")
        if args.max_attempts < 1:
            ap.error("--max-attempts must be >= 1")
        if args.liveness is not None and args.executor == "thread":
            ap.error("--liveness requires --executor process or remote "
                     "(threads have no peer to heartbeat)")
        if (args.host or args.listen or args.agents is not None) \
                and args.executor != "remote":
            ap.error("--host/--listen/--agents require --executor remote")
        if args.executor == "remote" and not args.host and not args.listen:
            ap.error("--executor remote needs --host HOST:PORT (dial "
                     "listening agents) and/or --listen HOST:PORT "
                     "[--agents N] (accept dial-in agents)")
        if args.from_store is not None and args.store is None:
            ap.error("--from-store streams out of --store; pass --store "
                     "DIR too")
        if not args.job and args.from_store is None:
            ap.error("nothing to replay: give scenario jobs and/or "
                     "--from-store")
    if args.cmd == "trace":
        if args.repeat < 1:
            ap.error("--repeat must be >= 1")
        if args.window is not None and args.window < 1:
            ap.error("--window must be >= 1")
    return {"list": _cmd_list, "run": _cmd_run, "fleet": _cmd_fleet,
            "serve": _cmd_serve, "trace": _cmd_trace}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())

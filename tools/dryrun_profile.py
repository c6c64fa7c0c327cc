#!/usr/bin/env python3
"""Profile one dry-run cell's host time with cProfile.

Runs one cell of the port's dry-run (``repro_torch.launch.dryrun``) under
``cProfile`` for at most ``--seconds`` (the run is stopped there, so a
cell too slow to finish still shows where its time went) and prints one
JSON object: whether the cell finished, the profiled seconds, and the
``--top`` functions by their own time and by cumulative time, each with
its calls and seconds.

    python3 tools/dryrun_profile.py --arch seamless-m4t-medium
        --shape train_4k --multi-pod [--seconds 600] [--top 25] [--src PATH]

``--src`` names the ``src`` directory whose ``repro_torch`` runs (default:
this checkout's).  No card is needed.
"""
import argparse
import cProfile
import json
import os
import pstats
import signal
import sys
import threading
import time
from collections import Counter


class _Stop(BaseException):
    """Raised by the alarm: not an ``Exception``, so that no handler on
    the way up takes it for a failure of the cell."""


def main() -> None:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(here, "src"))
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--seconds", type=int, default=600)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--every", type=float, default=0.5)
    ap.add_argument("--mesh-device", choices=("cpu", "cuda"), default=None)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh

    shape = SHAPES[args.shape]
    mesh = make_production_mesh(multi_pod=args.multi_pod,
                                device_type=args.mesh_device)
    run = dryrun._run_config(shape, arch=args.arch)

    def stop(*_):
        raise _Stop()
    signal.signal(signal.SIGALRM, stop)
    prof = cProfile.Profile()
    finished = False
    samples = Counter()
    done = threading.Event()
    main_id = threading.get_ident()

    def sample():
        while not done.wait(args.every):
            frame = sys._current_frames().get(main_id)
            while frame is not None:
                path = frame.f_code.co_filename.replace(os.sep, "/")
                if "repro_torch/" in path and "core/op_analysis" not in path:
                    samples[f"{_short(path)}:{frame.f_lineno} "
                            f"{frame.f_code.co_name}"] += 1
                    break
                frame = frame.f_back
    threading.Thread(target=sample, daemon=True).start()
    t0 = time.perf_counter()
    signal.alarm(args.seconds)
    prof.enable()
    try:
        dryrun.lower_cell(get_config(args.arch), shape, mesh, run)
        finished = True
    except _Stop:
        pass
    finally:
        prof.disable()
        signal.alarm(0)
        done.set()
    seconds = time.perf_counter() - t0
    st = pstats.Stats(prof)

    def top(key):
        rows = []
        for (path, line, name), (cc, nc, tt, ct, _) in st.stats.items():
            rows.append((tt if key == "tottime" else ct, nc,
                         f"{_short(path)}:{line} {name}"))
        rows.sort(key=lambda r: -r[0])
        return [{"fn": f, "calls": n, "s": s} for s, n, f in
                rows[:args.top]]
    print(json.dumps({"arch": args.arch, "shape": args.shape,
                      "multi_pod": args.multi_pod, "finished": finished,
                      "seconds": seconds, "by_own_time": top("tottime"),
                      "by_cumulative_time": top("cumtime"),
                      "sampled_lines": [
                          {"line": k, "share": n / max(1, sum(
                              samples.values()))}
                          for k, n in samples.most_common(args.top)]},
                     indent=1))


def _short(path: str) -> str:
    path = path.replace(os.sep, "/")
    for mark in ("site-packages/", "repro_torch/"):
        if mark in path:
            return path[path.index(mark) + (len(mark) if mark ==
                                            "site-packages/" else 0):]
    return path


if __name__ == "__main__":
    main()

"""The program's own spans, counters and segment row times in a run's
window, and the arithmetic the per-layer metrics read them with.

``recorded(run)`` is what the program's span recorder holds for the
run's measured window: ``spans`` (dicts of ``name``, ``id``, ``parent``,
``request``, ``start_ns``, ``end_ns``, ``attrs``, ``counts``),
``counters`` (the window's sums) and ``rows`` (one dict a timed segment
launch, with each row's device ``ns`` and planned ``flops`` and
``bytes``).  The window is the benchmark's own ``window`` span.  The
recorder is the module ``repro_torch.obs.spans`` as the runner's program
loaded it into this process: it is looked up among the loaded modules,
never imported, so nothing here imports or loads the program, and a
program that records no spans gives None.  Every function returns None
where there is nothing to read."""
from __future__ import annotations

import sys
from typing import Dict, Iterable, Optional

from synbench.core.roofline import share

#: the program's span recorder, by the name it is loaded under
RECORDER = "repro_torch.obs.spans"


def recorded(run) -> Optional[Dict]:
    """What the program recorded in the run's window, or None: no
    ``window`` span, or no recorder loaded."""
    bounds = [(s, e) for n, s, e in run.spans.done if n == "window"]
    rec = sys.modules.get(RECORDER)
    if not bounds or rec is None or not hasattr(rec, "window"):
        return None
    t0, t1 = bounds[-1]
    return rec.window(t0, t1)


def ms_per_root(program: Optional[Dict], names: Iterable[str],
                root: str) -> Optional[float]:
    """Host milliseconds in the spans named ``names`` under the window's
    root spans named ``root``, over the number of those roots."""
    if not program:
        return None
    spans = program.get("spans") or []
    roots = {s["id"] for s in spans
             if s["name"] == root and s["parent"] is None}
    if not roots:
        return None
    names = set(names)
    ns = sum(s["end_ns"] - s["start_ns"] for s in spans
             if s["name"] in names and s["request"] in roots)
    return ns / 1e6 / len(roots)


def rows_roofline(program: Optional[Dict], leg: str, peak_flops: float,
                  bytes_per_s: float) -> Optional[float]:
    """Over the launched rows whose larger leg is ``leg`` (``"burn"``: the
    operations at ``peak_flops``; ``"ring"``: the bytes at
    ``bytes_per_s``), their bound (each row's larger leg) over their
    device time, in percent."""
    if not program:
        return None
    bound = took_ns = 0.0
    for launch in program.get("rows") or []:
        for ns, f, b in zip(launch["ns"], launch["flops"], launch["bytes"]):
            t_ops, t_bytes = f / peak_flops, b / bytes_per_s
            if (t_ops >= t_bytes) == (leg == "burn"):
                bound += max(t_ops, t_bytes)
                took_ns += ns
    return share(bound, took_ns / 1e9)


def counter(program: Optional[Dict], name: str) -> Optional[int]:
    """The window's sum of the counter ``name``."""
    if not program:
        return None
    return (program.get("counters") or {}).get(name)

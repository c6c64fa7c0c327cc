"""``BENCHMARK.json`` and the files a cell is found by: its configuration
(``configs/<config>.json``) with the reference module that file names
(``reference/<reference>.py``), its traffic mix (``traffic/<mix>.json``)
with the runner that file names (``runners/<runner>.py``), and the
readers of its per-layer metrics (``metrics/<metric>.py``; a metric split
by cell, ``emulate_mfu.decode``, is read by ``metrics/emulate_mfu.py``
unless a file of its whole name is there)."""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
from dataclasses import dataclass, field
from typing import Dict, List

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def merge(base: Dict, over: Dict) -> Dict:
    """``base`` with ``over``'s keys laid over it, nested dicts merged."""
    out = dict(base)
    for k, v in over.items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and isinstance(
            out.get(k), dict) else v
    return out


def reader_path(name: str) -> str:
    """``metrics/<name>.py``, else the file of the name's part before its
    first dot."""
    path = os.path.join(HERE, "metrics", name + ".py")
    if os.path.exists(path):
        return path
    return os.path.join(HERE, "metrics", name.split(".")[0] + ".py")


def load_reader(name: str):
    """The module that reads the per-layer metric ``name``."""
    path = reader_path(name)
    spec = importlib.util.spec_from_file_location(
        "synbench.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    bench: Dict
    workload: Dict
    config: Dict                    # configs/<config>.json
    mix: Dict                       # traffic/<mix>.json
    end_to_end: List[Dict] = field(default_factory=list)
    per_layer: List[Dict] = field(default_factory=list)

    @property
    def sizes(self) -> Dict:
        """The configuration's keys as run: the published ``config`` with
        the program's ``departures`` from it laid over."""
        return merge(self.config["config"],
                     self.config.get("departures", {}))

    def reference(self):
        return importlib.import_module(
            "synbench.reference." + self.config["reference"])

    def runner(self):
        return importlib.import_module("synbench.runners."
                                       + self.mix["runner"])


def _applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(root: str, cell: str, rehearse: bool = False) -> Cell:
    """The cell named ``cell`` of ``<root>/BENCHMARK.json``.  Under
    ``rehearse`` the configuration's and the mix's ``rehearsal`` blocks
    are laid over them (a tiny size for a CPU run)."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    by_name = {w["name"]: w for w in bench["workloads"]}
    if cell not in by_name:
        raise SystemExit(f"synbench: no workload {cell!r} in BENCHMARK.json "
                         f"(have {sorted(by_name)})")
    w = by_name[cell]
    config = load_json(os.path.join(HERE, "configs", w["config"] + ".json"))
    mix = load_json(os.path.join(HERE, "traffic", w["traffic"] + ".json"))
    if rehearse:
        config = dict(config, config=merge(config["config"],
                                           config.get("rehearsal", {})))
        mix = merge(mix, mix.get("rehearsal", {}))
    return Cell(name=cell, bench=bench, workload=w, config=config, mix=mix,
                end_to_end=[m for m in bench["end_to_end"]
                            if _applies(m, cell)],
                per_layer=[m for m in bench["per_layer"]
                           if _applies(m, cell)])

"""What the runners share: the program's configuration, built from the
cell's configuration file and held to it."""
from __future__ import annotations

import dataclasses


def _get(obj, path: str):
    for part in path.split("."):
        obj = getattr(obj, part)
    return obj


def _replace(obj, path: str, value):
    head, _, rest = path.partition(".")
    if not rest:
        return dataclasses.replace(obj, **{head: value})
    return dataclasses.replace(obj, **{head: _replace(getattr(obj, head),
                                                      rest, value)})


def port_config(cell, ref, rehearse: bool):
    """The program's ``ModelConfig`` for the cell: the architecture the
    configuration file names, which must hold every field the file fixes
    (``ref.port_fields``); a rehearsal lays the file's tiny sizes over
    it instead."""
    from repro_torch.configs import get_config
    cfg = get_config(cell.config["port_arch"])
    want = ref.port_fields(cell.sizes)
    if rehearse:
        for path, v in want.items():
            cfg = _replace(cfg, path, v)
        return cfg
    differ = {p: (_get(cfg, p), v) for p, v in want.items()
              if _get(cfg, p) != v}
    if differ:
        raise SystemExit(f"synbench: the program's {cfg.name} departs from "
                         f"configs/{cell.workload['config']}.json: "
                         f"{differ} (program, file)")
    return cfg

"""Tagged profile store (the paper's MongoDB replaced by chunked JSON files).

Keys are (command, tags) exactly as in the paper §IV: repeated profiles of the
same key accumulate for statistical analysis (mean/σ per metric).  Documents
are chunked at ~14 MB to stay under the paper's infamous 16 MB MongoDB
document limit (§IV-E.9) — kept here as a compatibility contract so profiles
can round-trip into a real MongoDB later.
"""
from __future__ import annotations

import hashlib
import json
import math
import os
from dataclasses import dataclass
from typing import Dict, List, Optional

from repro_torch.core.metrics import SynapseProfile

DOC_LIMIT_BYTES = 14 * 1024 * 1024


def _key_hash(command: str, tags: Dict[str, str]) -> str:
    tag = ",".join(f"{k}={v}" for k, v in sorted(tags.items()))
    return hashlib.sha1(f"{command}|{tag}".encode()).hexdigest()[:16]


@dataclass
class ProfileStats:
    n: int
    mean: Dict[str, float]
    std: Dict[str, float]


class ProfileStore:
    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._index_path = os.path.join(root, "index.json")

    # -- index ---------------------------------------------------------------

    def _load_index(self) -> Dict:
        if os.path.exists(self._index_path):
            with open(self._index_path) as f:
                return json.load(f)
        return {}

    def _save_index(self, idx: Dict):
        tmp = self._index_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(idx, f, indent=1)
        os.replace(tmp, self._index_path)

    # -- API -----------------------------------------------------------------

    def add(self, profile: SynapseProfile) -> str:
        h = _key_hash(profile.command, profile.tags)
        idx = self._load_index()
        ent = idx.setdefault(h, {"command": profile.command,
                                 "tags": profile.tags, "runs": []})
        run_id = f"{h}-{len(ent['runs']):04d}"
        doc = profile.to_json()
        n_chunks = max(1, math.ceil(len(doc) / DOC_LIMIT_BYTES))
        paths = []
        for c in range(n_chunks):
            p = os.path.join(self.root, f"{run_id}.{c}.json")
            with open(p, "w") as f:
                f.write(doc[c * DOC_LIMIT_BYTES:(c + 1) * DOC_LIMIT_BYTES])
            paths.append(os.path.basename(p))
        ent["runs"].append({"id": run_id, "chunks": paths,
                            "created_at": profile.created_at})
        self._save_index(idx)
        return run_id

    def query(self, command: str, tags: Optional[Dict[str, str]] = None
              ) -> List[SynapseProfile]:
        h = _key_hash(command, tags or {})
        idx = self._load_index()
        ent = idx.get(h)
        if not ent:
            return []
        return self._load_runs(ent)

    def _load_run(self, run: Dict) -> SynapseProfile:
        doc = ""
        for chunk in run["chunks"]:
            with open(os.path.join(self.root, chunk)) as f:
                doc += f.read()
        return SynapseProfile.from_json(doc)

    def _load_runs(self, ent: Dict) -> List[SynapseProfile]:
        return [self._load_run(run) for run in ent["runs"]]

    def latest(self, command: str, tags=None) -> Optional[SynapseProfile]:
        profiles = self.query(command, tags)
        return profiles[-1] if profiles else None

    def find(self, tags: Dict[str, str], command: Optional[str] = None
             ) -> List[SynapseProfile]:
        """All profiles whose tags are a superset of ``tags``.

        Cross-key lookup the exact-(command, tags) ``query`` can't do: e.g.
        every stored run with ``{"scenario": "serving_traffic"}`` regardless
        of the parameter tags it was generated with.  Eager form of
        ``stream`` — prefer ``stream`` when the result set may be large.
        """
        return list(self.stream(tags, command))

    def stream(self, tags: Optional[Dict[str, str]] = None,
               command: Optional[str] = None):
        """Lazily yield stored profiles one at a time, oldest run first
        within each key (superset tag match, like ``find``; no filter
        streams the whole store).

        This is the fleet-feeding path (the fleet is not ported yet): it
        replays a store's worth of captured profiles without
        materializing every document up front — the first step toward
        replay-the-production-day fleets that outsize memory.  The index
        is snapshotted once at the first ``next()``; runs added
        afterwards appear in the next ``stream`` call.
        """
        idx = self._load_index()
        for _, ent in sorted(idx.items()):
            if command is not None and ent["command"] != command:
                continue
            if not all(ent["tags"].get(k) == v
                       for k, v in (tags or {}).items()):
                continue
            for run in ent["runs"]:
                yield self._load_run(run)

    def keys(self) -> List[Dict]:
        idx = self._load_index()
        return [{"command": v["command"], "tags": v["tags"],
                 "n_runs": len(v["runs"])} for v in idx.values()]

    # -- statistics over repeated runs (paper: mean/σ per metric) ------------

    def stats(self, command: str, tags=None) -> Optional[ProfileStats]:
        profiles = self.query(command, tags)
        if not profiles:
            return None
        rows = []
        for p in profiles:
            t = p.totals
            row = {"flops": t.flops, "hbm_bytes": t.hbm_bytes,
                   "ici_bytes": t.ici_total,
                   "storage_read_bytes": t.storage_read_bytes,
                   "storage_write_bytes": t.storage_write_bytes,
                   "peak_mem_bytes": t.peak_mem_bytes,
                   "n_samples": float(len(p.samples))}
            if p.wall_time_s is not None:
                row["wall_time_s"] = p.wall_time_s
            rows.append(row)
        keys = set().union(*[set(r) for r in rows])
        mean, std = {}, {}
        for k in keys:
            vals = [r[k] for r in rows if k in r]
            mu = sum(vals) / len(vals)
            mean[k] = mu
            std[k] = (sum((v - mu) ** 2 for v in vals) / len(vals)) ** 0.5
        return ProfileStats(n=len(rows), mean=mean, std=std)

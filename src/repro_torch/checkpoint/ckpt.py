"""Atomic, async checkpoints in the JAX package's layout, so a checkpoint
written by either package restores in the other.

Layout:  <root>/step_<N>/
             manifest.json        (step, creation time, extra, and for each
                                   leaf its file, shape, dtype and sha1)
             <leaf-path>.npy      (one file per tensor leaf)
             COMMIT               (written last; a checkpoint without COMMIT
                                   is invisible)

* Atomicity: write into step_<N>.tmp, ``os.replace`` it to step_<N>, then
  COMMIT.
* Async: ``save_async`` snapshots every leaf to host memory synchronously
  (a copy, also of a CPU tensor, which the next step may update in place)
  and writes the files on a worker thread.
* Leaves are written, hashed, read and verified on a pool of threads
  (half the cores): ``np.save``, ``np.load`` and ``hashlib`` release the
  interpreter lock.
* bfloat16: numpy has no bf16 kind, so a bf16 leaf is stored as its raw
  two-byte words (a ``V2`` array, as numpy writes the JAX package's
  ml_dtypes bf16) under the manifest dtype ``"bfloat16"``, and read back
  as ``torch.bfloat16``.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve
from repro_torch.obs import clock as obs_clock

MANIFEST = "manifest.json"
COMMIT = "COMMIT"
BF16 = "bfloat16"
_WORD = np.dtype("V2")            # a bf16 leaf on the host
# half the cores: the train loop that launches the next step keeps the rest
_IO_THREADS = max(1, min(8, (os.cpu_count() or 2) // 2))


def _leaf_paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_paths(tree[k], prefix + (str(k),))
    else:
        yield prefix, tree


def _set_path(root, path, value):
    cur = root
    for p in path[:-1]:
        cur = cur.setdefault(p, {})
    cur[path[-1]] = value


def tree_flatten_named(tree) -> Dict[str, Any]:
    return {"/".join(p): v for p, v in _leaf_paths(tree)}


def _to_host(x) -> np.ndarray:
    """A host copy of a leaf: a tensor (bf16 as two-byte words) or an
    array."""
    if not isinstance(x, torch.Tensor):
        return np.array(x)
    t = x.detach()
    bf16 = t.dtype == torch.bfloat16
    if bf16:
        t = t.view(torch.int16)
    a = t.cpu().numpy()
    if t.device.type == "cpu":   # .numpy() shares the tensor's memory
        a = a.copy()
    return a.view(_WORD) if bf16 else a


def _dtype_name(arr: np.ndarray) -> str:
    return BF16 if arr.dtype == _WORD else str(arr.dtype)


def _sha1(arr: np.ndarray) -> str:
    words = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
    return hashlib.sha1(words).hexdigest()[:12]


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A leaf read from disk as a tensor on the host."""
    if dtype == BF16:
        return torch.from_numpy(np.ascontiguousarray(arr).view(
            np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class CheckpointManager:
    """Checkpoints under ``root``, the newest ``keep`` kept; ``restore``
    places leaves on ``device`` (``"cuda"`` unless named), or on the
    device ``restore`` is given."""

    def __init__(self, root: str, keep: int = 3, device: DeviceLike = None):
        self.root = root
        self.keep = keep
        self.device = device
        os.makedirs(root, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- save -----------------------------------------------------------------

    def save(self, step: int, state, extra: Optional[Dict] = None):
        self.wait()
        self._write(step, self._snapshot(state), extra or {})

    def save_async(self, step: int, state, extra: Optional[Dict] = None):
        """Snapshot synchronously (device->host), write on a worker thread."""
        self.wait()
        host = self._snapshot(state)

        def work():
            try:
                self._write(step, host, extra or {})
            except BaseException as e:  # noqa: BLE001 — re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    @staticmethod
    def _snapshot(state) -> Dict[str, np.ndarray]:
        return {name: _to_host(x)
                for name, x in tree_flatten_named(state).items()}

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write(self, step: int, leaves: Dict[str, np.ndarray], extra: Dict):
        final = os.path.join(self.root, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        def leaf(item):
            name, arr = item
            fn = name.replace("/", "__") + ".npy"
            np.save(os.path.join(tmp, fn), arr)
            return name, {"file": fn, "shape": list(arr.shape),
                          "dtype": _dtype_name(arr), "sha1": _sha1(arr)}

        with ThreadPoolExecutor(_IO_THREADS) as pool:
            metas = dict(pool.map(leaf, leaves.items()))
        manifest = {"step": step, "created_at": obs_clock.wall(),
                    "extra": extra, "leaves": metas}
        with open(os.path.join(tmp, MANIFEST), "w") as f:
            json.dump(manifest, f, indent=1)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        with open(os.path.join(final, COMMIT), "w") as f:
            f.write(str(step))
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.root, f"step_{s:08d}"),
                          ignore_errors=True)

    # -- restore ---------------------------------------------------------------

    def all_steps(self):
        out = []
        for d in sorted(os.listdir(self.root)):
            if d.startswith("step_") and not d.endswith(".tmp") and \
                    os.path.exists(os.path.join(self.root, d, COMMIT)):
                out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, *,
                device: DeviceLike = None,
                verify: bool = True) -> Tuple[Any, Dict]:
        """Returns (state_tree, manifest_extra), every leaf on ``device``
        (the manager's device when None)."""
        dev = resolve(device if device is not None else self.device)
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint under {self.root}")
        d = os.path.join(self.root, f"step_{step:08d}")
        with open(os.path.join(d, MANIFEST)) as f:
            manifest = json.load(f)

        def leaf(item):
            name, meta = item
            arr = np.load(os.path.join(d, meta["file"]))
            if verify:
                h = _sha1(arr)
                if h != meta["sha1"]:
                    raise IOError(f"checkpoint corruption in {name}: "
                                  f"{h} != {meta['sha1']}")
            return name, _from_host(arr, meta["dtype"]).to(dev)

        tree: Dict = {}
        with ThreadPoolExecutor(_IO_THREADS) as pool:
            for name, t in pool.map(leaf, manifest["leaves"].items()):
                _set_path(tree, tuple(name.split("/")), t)
        return tree, manifest.get("extra", {})

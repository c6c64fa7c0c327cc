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
* Sharded states: tensors are stored UNSHARDED, the JAX package's format.
  In a process group every rank snapshots a DTensor leaf's whole value
  (``full_tensor``, a collective: every rank takes the leaves in one
  order) and rank 0 alone keeps it, writes, commits and collects old
  steps.  ``save``, ``save_async`` + ``wait`` end with every rank
  agreeing that the step is committed, and a write error on rank 0 is
  raised on every rank.  The ranks share the checkpoint's directory.
* Elastic restore: ``restore(shardings=...)`` reads each whole leaf on
  every rank and keeps the rank's own shard on the mesh of its
  ``NamedSharding``, which may differ from the mesh at save time, with no
  collective (``parallel.sharding.distribute``).
"""
from __future__ import annotations

import hashlib
import json
import os
import pickle
import shutil
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve
from repro_torch.obs import clock as obs_clock
from repro_torch.parallel.sharding import distribute, whole

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


def _in_group() -> bool:
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def _writes() -> bool:
    """Whether this process writes checkpoints: rank 0 of the default
    process group, or a process outside one."""
    import torch.distributed as dist
    return not _in_group() or dist.get_rank() == 0


def _agree(err: Optional[BaseException]) -> Optional[BaseException]:
    """Rank 0's write error (or None) on every rank of the default group:
    the ranks leave together, and none waits in a collective for a rank
    that raised."""
    import torch.distributed as dist
    msg = [None]
    if dist.get_rank() == 0 and err is not None:
        try:
            pickle.dumps(err)
            msg[0] = err
        except Exception:  # noqa: BLE001 — sent as its message instead
            msg[0] = RuntimeError(f"{type(err).__name__}: {err}")
    dist.broadcast_object_list(msg, src=0)
    return err if dist.get_rank() == 0 else msg[0]


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
        self._pending = False      # a save that wait() has not closed

    # -- save -----------------------------------------------------------------

    def save(self, step: int, state, extra: Optional[Dict] = None):
        self.wait()
        host = self._snapshot(state)
        self._pending = True
        if _writes():
            try:
                self._write(step, host, extra or {})
            except BaseException as e:  # noqa: BLE001 — re-raised by wait()
                self._error = e
        self.wait()

    def save_async(self, step: int, state, extra: Optional[Dict] = None):
        """Snapshot synchronously (device->host), write on a worker thread."""
        self.wait()
        host = self._snapshot(state)
        self._pending = True
        if not _writes():
            return

        def work():
            try:
                self._write(step, host, extra or {})
            except BaseException as e:  # noqa: BLE001 — re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    @staticmethod
    def _snapshot(state) -> Dict[str, np.ndarray]:
        """Host copies of the leaves, on the writing rank; every rank
        gathers each DTensor leaf, in ``tree_flatten_named``'s order, and
        the others drop it at once."""
        keep = _writes()
        out = {}
        for name, x in tree_flatten_named(state).items():
            x = whole(x)
            if keep:
                out[name] = _to_host(x)
            del x
        return out

    def wait(self):
        """Wait for the last save; in a process group, every rank leaves
        once rank 0 committed it, or raises rank 0's write error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        err, self._error = self._error, None
        if self._pending and _in_group():
            err = _agree(err)
        self._pending = False
        if err is not None:
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

    def restore(self, step: Optional[int] = None, *, shardings=None,
                device: DeviceLike = None,
                verify: bool = True) -> Tuple[Any, Dict]:
        """Returns (state_tree, manifest_extra).

        ``shardings``: a tree of ``parallel.sharding.NamedSharding``
        matching the state's: a leaf that has one is laid out on its mesh,
        which may differ from the mesh at save time (elastic restore),
        each rank keeping its own shard.  Every other leaf goes to
        ``device`` (the manager's device when None)."""
        dev = resolve(device if device is not None else self.device)
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint under {self.root}")
        d = os.path.join(self.root, f"step_{step:08d}")
        with open(os.path.join(d, MANIFEST)) as f:
            manifest = json.load(f)
        named = tree_flatten_named(shardings) if shardings is not None \
            else {}

        def leaf(item):
            name, meta = item
            arr = np.load(os.path.join(d, meta["file"]))
            if verify:
                h = _sha1(arr)
                if h != meta["sha1"]:
                    raise IOError(f"checkpoint corruption in {name}: "
                                  f"{h} != {meta['sha1']}")
            return name, _from_host(arr, meta["dtype"])

        tree: Dict = {}
        with ThreadPoolExecutor(_IO_THREADS) as pool:
            for name, t in pool.map(leaf, manifest["leaves"].items()):
                sh = named.get(name)
                t = t.to(dev) if sh is None else \
                    distribute(t, sh.mesh, sh.spec)
                _set_path(tree, tuple(name.split("/")), t)
        return tree, manifest.get("extra", {})

"""Builds the port's CUDA kernels into one shared library and loads it.

The sources are ``src/repro_torch/csrc/*.cu``.  Each has a plain C
interface and includes no PyTorch header, so ``nvcc`` compiles it in
seconds.  At first use every source is compiled for ``sm_90a`` (one
``nvcc`` per source, all started together), the objects are linked into
``build/repro_torch/libsynapse_kernels-<hash>.so`` at the repository root,
and the library is loaded with ``ctypes``.  The hash covers the sources and
the flags, so an edited source builds a new library.  Nothing here runs
when a module is imported: CPU-only callers never build.

``nvcc`` is taken from ``$CUDA_HOME/bin``, else from ``PATH``, else from
the toolkit's default prefix; a missing compiler or a failed compile
raises with the compiler's output.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
# no --use_fast_math: the kernels must keep exact float32 arithmetic
FLAGS = ["-O3", "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v", *ARCH]
LOG_NAME = "build.log"

_lock = threading.Lock()
_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int64
_D = ctypes.c_double
#: the C interface of the library: name -> (result type, argument types);
#: the launchers return a ``cudaError_t``, 0 on success
SIGNATURES = {
    # x, out, scratch, tile, iters, device, stream
    "synapse_burn_tile": (ctypes.c_int, [_P, _P, _P, _I, _I, _I, _P]),
    # tile, iters -> the kernels synapse_burn_tile launches for them
    "synapse_burn_tile_launches": (ctypes.c_int64, [_I, _I]),
    # x, out, scratch, n, dtype code, passes, device, stream
    "synapse_stream_pass": (ctypes.c_int,
                            [_P, _P, _P, _I, _I, _I, _I, _P]),
    # ring, n, slots, start, passes, device, stream
    "synapse_stream_ring": (ctypes.c_int, [_P, _I, _I, _I, _I, _I, _P]),
    # device -> the L2 cache's bytes, or minus a CUDA error code
    "synapse_l2_cache_bytes": (ctypes.c_int64, [_I]),
    # table, n_rows, x, out, ring, n, slots, start, tile, total compute
    # iterations, collective carry, its shards, its shard's elements, its
    # kind code, counts, row stamps (null: untimed), device, stream
    "synapse_segment": (ctypes.c_int, [_P, _I, _P, _P, _P, _I, _I, _I, _I,
                                       _I, _P, _I, _I, _I, _P, _P, _I, _P]),
    # tile, wire carry's shards (0: none) and shard elements, device, info
    # (int64[5]: grid, burn CTAs, active clusters, shared memory a CTA,
    # the device's per-CTA limit)
    "synapse_segment_grid": (ctypes.c_int, [_I, _I, _I, _I, _P]),
    # q, k, v, out, BH, BKV, Sq, Sk, hd, dtype code, causal, window (-1 for
    # none), softcap (0 for none), scale, device, stream
    "synapse_flash_attention": (ctypes.c_int, [_P, _P, _P, _P, _I, _I, _I,
                                               _I, _I, _I, _I, _I, _D, _D,
                                               _I, _P]),
    # x, out, outer, n, post, blk, kind code, device, stream
    "synapse_collective": (ctypes.c_int, [_P, _P, _I, _I, _I, _I, _I, _I,
                                          _P]),
    # x, sink, n, reps, device, stream (a measuring probe, no port)
    "synapse_l2_read": (ctypes.c_int, [_P, _P, _I, _I, _I, _P]),
    # carry, n, CTAs, kind code, steps, medium (0 L2, 1 the peer CTA's
    # shared memory), cycles, device, stream (a measuring probe, no port)
    "synapse_wire_probe": (ctypes.c_int, [_P, _I, _I, _I, _I, _I, _P, _I,
                                          _P]),
    "synapse_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


def find_nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: put the CUDA toolkit's bin "
                       "directory on PATH or set CUDA_HOME; the port's "
                       "kernels are built from source at first use")


def sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libsynapse_kernels-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    nvcc = find_nvcc()
    stem = out.stem
    units = [s for s in sources() if s.suffix == ".cu"]
    procs = []
    for src in units:
        obj = out.parent / f"{stem}.{src.stem}.o"
        procs.append((src, obj, subprocess.Popen(
            [nvcc, *FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for src, _, p in procs:
        text, _ = p.communicate()
        log.append(f"== {src.name} (rc {p.returncode})\n{text}")
        if p.returncode:
            failed.append(src.name)
    tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
    if not failed:
        link = subprocess.run(
            [nvcc, *ARCH, "-shared", "-o", str(tmp),
             *(str(obj) for _, obj, _ in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(f"== link (rc {link.returncode})\n{link.stdout}")
        if link.returncode:
            failed.append("link")
    (out.parent / LOG_NAME).write_text("\n".join(log))
    for _, obj, _ in procs:
        obj.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the CUDA kernels failed at "
                           f"{', '.join(failed)}:\n" + "\n".join(log))
    os.replace(tmp, out)


def load() -> ctypes.CDLL:
    """The kernel library, built first if this source tree has none."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            path.parent.mkdir(parents=True, exist_ok=True)
            # serialise builds across processes sharing the checkout
            with open(path.parent / ".lock", "w") as lk:
                fcntl.flock(lk, fcntl.LOCK_EX)
                try:
                    if not path.exists():
                        _build(path)
                finally:
                    fcntl.flock(lk, fcntl.LOCK_UN)
            lib = ctypes.CDLL(str(path))
            for name, (restype, argtypes) in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
        return _lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launcher reported a CUDA error."""
    if err != 0:
        name = lib.synapse_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({name}) at launch")

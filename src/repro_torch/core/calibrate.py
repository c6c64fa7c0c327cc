"""Device calibration microbenchmarks.

The paper's compute atom is an assembly matmul loop whose throughput defines
"the maximum efficiency Synapse can emulate"; equivalently we measure what
the device actually sustains (matmul FLOP/s, stream bytes/s) and what the
host's storage sustains (file I/O bytes/s) once, cache it on disk, and atoms
use it to convert a resource amount into loop iterations.

Device work is timed with CUDA events on a card and with the host clock on
the CPU.  The cache is the port's own, one file per device type, so numbers
measured by the JAX package (or on another device type) never drive these
atoms.
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from dataclasses import asdict, dataclass

import torch

from repro_torch.device import DeviceLike, resolve

CACHE_DIR = tempfile.gettempdir()


def cache_path(device_type: str) -> str:
    return os.path.join(CACHE_DIR, f"synapse_torch_calib_{device_type}.json")


@dataclass(frozen=True)
class HostCalibration:
    flops_per_s: float
    stream_bytes_per_s: float
    storage_write_bps: float
    storage_read_bps: float

    def to_json(self):
        return json.dumps(asdict(self))


def _time_host(fn, min_s=0.2, warmup=1):
    for _ in range(warmup):
        fn()
    n, t0 = 0, time.perf_counter()
    while True:
        fn()
        n += 1
        dt = time.perf_counter() - t0
        if dt > min_s:
            return dt / n


def _time_device(fn, device: torch.device, min_s=0.2, warmup=1):
    """Seconds per call of ``fn``: CUDA events around a doubling batch of
    calls on a card, the host clock on the CPU (where ops are synchronous)."""
    if device.type != "cuda":
        return _time_host(fn, min_s, warmup)
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize(device)
    n = 1
    while True:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        dt = start.elapsed_time(end) / 1e3
        if dt > min_s:
            return dt / n
        n *= 2


def measure_flops(device: DeviceLike = None, m: int = 512) -> float:
    dev = resolve(device)
    a = torch.ones((m, m), dtype=torch.float32, device=dev)
    dt = _time_device(lambda: a @ a, dev)
    return 2.0 * m ** 3 / dt


def measure_stream(device: DeviceLike = None, nbytes: int = 1 << 26) -> float:
    dev = resolve(device)
    a = torch.ones((nbytes // 4,), dtype=torch.float32, device=dev)
    dt = _time_device(lambda: a * 1.0000001, dev)
    return 2.0 * nbytes / dt              # read + write


def measure_storage(nbytes: int = 1 << 24, block: int = 1 << 20):
    buf = os.urandom(block)
    path = os.path.join(tempfile.gettempdir(), "synapse_torch_cal.bin")

    def wr():
        with open(path, "wb") as f:
            for _ in range(nbytes // block):
                f.write(buf)
            f.flush()
            os.fsync(f.fileno())

    dt_w = _time_host(wr, min_s=0.3, warmup=0)

    def rd():
        with open(path, "rb") as f:
            while f.read(block):
                pass

    dt_r = _time_host(rd, min_s=0.1)
    os.unlink(path)
    return nbytes / dt_w, nbytes / dt_r


def calibrate(force: bool = False,
              device: DeviceLike = None) -> HostCalibration:
    dev = resolve(device)
    path = cache_path(dev.type)
    if not force and os.path.exists(path):
        try:
            with open(path) as f:
                return HostCalibration(**json.load(f))
        except (OSError, ValueError, TypeError):
            pass                          # unreadable cache: measure again
    flops = measure_flops(dev)
    stream = measure_stream(dev)
    wr, rd = measure_storage()
    cal = HostCalibration(flops_per_s=flops, stream_bytes_per_s=stream,
                          storage_write_bps=wr, storage_read_bps=rd)
    with open(path, "w") as f:
        f.write(cal.to_json())
    return cal

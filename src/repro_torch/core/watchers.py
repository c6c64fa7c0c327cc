"""Runtime watcher plugins — the paper's profiling architecture, verbatim.

Each watcher runs in its own thread, sampling at a global rate (paper: max
10/s; we allow faster since /proc is cheap), with the paper's plugin
protocol: ``_pre_process`` / ``_sample`` / ``_post_process`` / ``_finalize``
(where a plugin may read other watchers' results to avoid duplicating
measurements, e.g. runtime).  Timestamps are per-watcher and unsynchronized,
exactly as the paper chose (IV-A): skew is preferred over sync overhead.

All stamps route through ``repro_torch.obs.clock``: sample timestamps are the
anchored wall projection of the monotonic clock, and every duration
(watcher wall_s, profiled-callable wall) is a monotonic difference — an
NTP step mid-profile can no longer produce a negative or inflated
duration.

These watchers profile *this* process (the host process driving the
device) — they observe the host side only; device-side consumption comes
from a static profile.
"""
from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from repro_torch.core.metrics import ResourceVector, Sample, SynapseProfile
from repro_torch.obs import clock as obs_clock

DEFAULT_SAMPLE_RATE = float(os.environ.get("SYNAPSE_SAMPLE_RATE", "10"))


class WatcherBase:
    """Paper §IV-A plugin structure."""

    name = "base"

    def __init__(self, pid: Optional[int] = None):
        self.pid = pid or os.getpid()
        self.samples: List[Dict[str, Any]] = []
        self.result: Dict[str, Any] = {}
        self._terminate = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._sample_interval = 1.0 / DEFAULT_SAMPLE_RATE
        #: a cumulative watcher's totals read in ``start`` (None: none read)
        self.baseline: Optional[Dict[str, float]] = None

    # -- plugin protocol ------------------------------------------------------
    def _pre_process(self, config: Dict):
        pass

    def _read(self) -> Optional[Dict[str, float]]:
        """A cumulative watcher's totals now; None where readings are
        absolute (memory)."""
        return None

    def _sample(self, now: float):
        raise NotImplementedError

    def _post_process(self):
        pass

    def _finalize(self, all_watchers: Dict[str, "WatcherBase"]):
        """May read other watchers' raw results (paper: avoids duplicate
        measurements such as overall runtime)."""

    # -- threaded run loop (paper listing) ------------------------------------
    def run(self, config: Dict):
        self._pre_process(config)
        self._sample_interval = 1.0 / config.get("sample_rate",
                                                 DEFAULT_SAMPLE_RATE)
        while not self._terminate.is_set():
            now = obs_clock.wall()        # anchored: step-free wall stamps
            try:
                self._sample(now)
            except Exception:  # noqa: BLE001 — a failing sampler must not
                pass           # kill the profiled run (paper P.2)
            self._terminate.wait(self._sample_interval)
        self._post_process()

    def start(self, config: Dict):
        # cumulative watchers read their totals once here, before the
        # profiled callable runs, so that the first sample holds only what
        # the callable consumed (the JAX package's first sample holds the
        # process's totals since it started: repro/core/watchers.py:196)
        try:
            self.baseline = self._read()
        except OSError:
            self.baseline = None
        self._thread = threading.Thread(target=self.run, args=(config,),
                                        daemon=True, name=f"watcher-{self.name}")
        self._thread.start()

    def stop(self):
        self._terminate.set()
        if self._thread:
            self._thread.join(timeout=5.0)


def _read_proc(path: str) -> str:
    with open(path) as f:
        return f.read()


class CPUWatcher(WatcherBase):
    """utime/stime from /proc/<pid>/stat (perf-stat stand-in: cycle counters
    need perf permissions; CPU-seconds × calibrated flop/s gives the same
    consumption estimate at our fidelity target)."""

    name = "cpu"

    def _pre_process(self, config):
        self._t0 = obs_clock.now()

    def _read(self) -> Dict[str, float]:
        parts = _read_proc(f"/proc/{self.pid}/stat").rsplit(")", 1)[1].split()
        utime, stime = int(parts[11]), int(parts[12])
        return {"cpu_s": (utime + stime) / os.sysconf("SC_CLK_TCK")}

    def _sample(self, now: float):
        self.samples.append({"t": now, **self._read()})

    def _post_process(self):
        self.result["wall_s"] = obs_clock.now() - self._t0
        if self.samples:
            self.result["cpu_s"] = self.samples[-1]["cpu_s"]
            self.result["cpu_series"] = self.samples


class MemWatcher(WatcherBase):
    """VmRSS / VmHWM from /proc/<pid>/status."""

    name = "mem"

    def _sample(self, now: float):
        rss = peak = 0
        for line in _read_proc(f"/proc/{self.pid}/status").splitlines():
            if line.startswith("VmRSS:"):
                rss = int(line.split()[1]) * 1024
            elif line.startswith("VmHWM:"):
                peak = int(line.split()[1]) * 1024
        # Some kernels/containers omit VmHWM; the max sampled RSS is the
        # best observable peak there.
        self.samples.append({"t": now, "rss": rss, "peak": peak or rss})

    def _post_process(self):
        if self.samples:
            self.result["peak_rss"] = max(s["peak"] for s in self.samples)
            self.result["mem_series"] = self.samples


class IOWatcher(WatcherBase):
    """read_bytes / write_bytes from /proc/<pid>/io."""

    name = "io"

    def _read(self) -> Dict[str, float]:
        rb = wb = 0
        for line in _read_proc(f"/proc/{self.pid}/io").splitlines():
            if line.startswith("read_bytes:"):
                rb = int(line.split()[1])
            elif line.startswith("write_bytes:"):
                wb = int(line.split()[1])
        return {"read": rb, "write": wb}

    def _sample(self, now: float):
        try:
            self.samples.append({"t": now, **self._read()})
        except PermissionError:
            return

    def _post_process(self):
        if self.samples:
            self.result["read_bytes"] = self.samples[-1]["read"] - \
                self.samples[0]["read"]
            self.result["write_bytes"] = self.samples[-1]["write"] - \
                self.samples[0]["write"]
            self.result["io_series"] = self.samples


class RuntimeProfiler:
    """Drives a set of watchers around a callable (the paper's profile())."""

    def __init__(self, sample_rate: float = DEFAULT_SAMPLE_RATE,
                 watchers=None):
        self.sample_rate = sample_rate
        self.watcher_classes = watchers or [CPUWatcher, MemWatcher, IOWatcher]

    def profile_callable(self, fn, *, command: str, tags=None,
                         flops_per_cpu_s: Optional[float] = None,
                         sysinfo=None) -> SynapseProfile:
        ws = {c.name: c() for c in self.watcher_classes}
        cfg = {"sample_rate": self.sample_rate}
        for w in ws.values():
            w.start(cfg)
        t0 = obs_clock.now()
        fn()
        wall = obs_clock.now() - t0
        for w in ws.values():
            w.stop()
        for w in ws.values():
            w._finalize(ws)
        return self._assemble(ws, wall, command, tags or {},
                              flops_per_cpu_s, sysinfo)

    def _assemble(self, ws, wall, command, tags, flops_per_cpu_s, sysinfo):
        """Combine unsynchronized per-watcher time series into uniform
        wall-clock samples (paper: postprocessing merges series)."""
        cpu = ws.get("cpu").samples if "cpu" in ws else []
        mem = ws.get("mem").samples if "mem" in ws else []
        io = ws.get("io").samples if "io" in ws else []
        n = max(len(cpu), len(mem), len(io), 1)
        t_start = min([s["t"] for s in (cpu + mem + io)] or [0.0])
        dt = wall / n
        samples = []
        # running totals start from the readings taken in ``start``
        cpu0 = _baseline(ws, "cpu")
        io0 = _baseline(ws, "io")
        prev_cpu = cpu0.get("cpu_s", 0.0)
        prev_r, prev_w = io0.get("read", 0.0), io0.get("write", 0.0)
        for i in range(n):
            r = ResourceVector()
            if i < len(cpu):
                d_cpu = cpu[i]["cpu_s"] - prev_cpu
                prev_cpu = cpu[i]["cpu_s"]
                if flops_per_cpu_s:
                    r.flops = max(d_cpu, 0.0) * flops_per_cpu_s
            if i < len(mem):
                r.host_mem_bytes = mem[i]["rss"]
                r.peak_mem_bytes = mem[i]["peak"]
            if i < len(io):
                r.storage_read_bytes = max(io[i]["read"] - prev_r, 0.0)
                r.storage_write_bytes = max(io[i]["write"] - prev_w, 0.0)
                prev_r, prev_w = io[i]["read"], io[i]["write"]
            samples.append(Sample(index=i, resources=r, duration_s=dt,
                                  label=f"t{i}"))
        prof = SynapseProfile(command=command, tags=tags, samples=samples,
                              sysinfo=sysinfo or host_sysinfo())
        prof.meta["wall_s"] = wall
        prof.meta["watcher_results"] = {
            k: {kk: vv for kk, vv in w.result.items()
                if not kk.endswith("_series")}
            for k, w in ws.items()}
        return prof


def _baseline(ws: Dict[str, WatcherBase], name: str) -> Dict[str, float]:
    """The totals watcher ``name`` read in ``start``; {} if it read none."""
    return getattr(ws.get(name), "baseline", None) or {}


def host_sysinfo() -> Dict[str, Any]:
    info = {"cores": os.cpu_count()}
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    info["mem_total"] = int(line.split()[1]) * 1024
                    break
    except OSError:
        pass
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    info["cpu"] = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    return info

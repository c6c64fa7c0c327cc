"""The port's runtime profiler against the JAX package's.

The port repairs one fault it used to copy: the reference's
``RuntimeProfiler._assemble`` starts its running CPU and storage totals at
0, so its first sample holds everything the process consumed since it
started.  The port's cumulative watchers read their totals in ``start()``,
before the profiled callable runs, and the first sample holds only what
followed.  These tests pin both behaviours and that the profiles still
cross between the packages.
"""
import os
import time

import repro.core as R
import repro.core.watchers as r_watchers
import repro_torch.core as T
import repro_torch.core.watchers as t_watchers

TICK_S = 1.0 / os.sysconf("SC_CLK_TCK")   # /proc/<pid>/stat's resolution


def _burn_cpu(seconds: float) -> None:
    end = time.process_time() + seconds
    x = 0
    while time.process_time() < end:
        x += sum(range(1000))


def _profile(pkg):
    """Burn CPU, then profile a short callable with one flop a CPU-second,
    so that a sample's flops are its CPU seconds.  Returns the profile and
    the process's CPU seconds just before and just after profiling."""
    _burn_cpu(0.3)
    before = time.process_time()
    prof = pkg.RuntimeProfiler(sample_rate=50).profile_callable(
        lambda: _burn_cpu(0.05), command="watch", flops_per_cpu_s=1.0)
    return prof, before, time.process_time()


def test_port_first_sample_excludes_cpu_before_start():
    prof, before, after = _profile(T)
    assert before >= 0.3
    first = prof.samples[0].resources.flops
    # the callable and the watcher threads used at most after - before
    could_have_used = after - before + 2 * TICK_S
    assert first <= could_have_used
    assert sum(s.resources.flops for s in prof.samples) <= could_have_used
    assert first < before / 2


def test_reference_first_sample_includes_cpu_before_start():
    """The JAX package keeps its behaviour (repro/core/watchers.py:196)."""
    prof, before, _ = _profile(R)
    assert prof.samples[0].resources.flops >= before - 2 * TICK_S


def test_repaired_profile_loads_in_reference():
    prof, _, _ = _profile(T)
    back = R.SynapseProfile.from_json(prof.to_json())
    assert back.to_json() == prof.to_json()
    assert back.totals.flops == prof.totals.flops


class _Fake:
    """A watcher's recorded samples without its thread."""

    def __init__(self, name, samples, baseline=None):
        self.name, self.samples, self.baseline = name, samples, baseline
        self.result = {}


def _assemble(mod, baseline):
    ws = {"cpu": _Fake("cpu", [{"t": 0.0, "cpu_s": 12.5},
                               {"t": 0.1, "cpu_s": 12.75}],
                       {"cpu_s": 12.0} if baseline else None),
          "io": _Fake("io", [{"t": 0.0, "read": 5000, "write": 900},
                             {"t": 0.1, "read": 7000, "write": 900}],
                      {"read": 4000, "write": 100} if baseline else None)}
    return mod.RuntimeProfiler()._assemble(ws, 0.2, "fake", {}, 2.0,
                                           {"cores": 1})


def test_port_assemble_starts_from_the_baseline():
    prof = _assemble(t_watchers, baseline=True)
    first, second = (s.resources for s in prof.samples)
    assert (first.flops, second.flops) == (1.0, 0.5)
    assert (first.storage_read_bytes, first.storage_write_bytes) == \
        (1000, 800)
    assert (second.storage_read_bytes, second.storage_write_bytes) == \
        (2000, 0)


def test_port_assemble_without_a_baseline_starts_from_zero():
    """A watcher that read no totals (say /proc/<pid>/io unreadable) leaves
    the running total at 0, as the reference does."""
    port = _assemble(t_watchers, baseline=False)
    ref = _assemble(r_watchers, baseline=True)   # the reference ignores it
    assert [s.to_dict() for s in port.samples] == \
        [s.to_dict() for s in ref.samples]
    assert port.samples[0].resources.flops == 25.0
    assert port.samples[0].resources.storage_read_bytes == 5000


def test_watchers_read_their_totals_at_start():
    cpu, io, mem = T.CPUWatcher(), T.IOWatcher(), T.MemWatcher()
    for w in (cpu, io, mem):
        w.start({"sample_rate": 50})
    for w in (cpu, io, mem):
        w.stop()
    assert cpu.baseline["cpu_s"] > 0
    assert cpu.samples and cpu.samples[0]["cpu_s"] >= cpu.baseline["cpu_s"]
    assert mem.baseline is None                  # absolute readings
    if io.samples:                               # /proc/<pid>/io readable
        assert io.samples[0]["read"] >= io.baseline["read"]

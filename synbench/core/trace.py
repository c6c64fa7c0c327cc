"""Reduction of a ``torch.profiler`` trace of the measured window to
device intervals: which kernels ran, for how long, how busy the card was
and where it stood idle."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from synbench.core.spans import Spans


@dataclass
class DeviceOp:
    name: str
    start_ns: int
    end_ns: int

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


def device_ops(prof) -> List[DeviceOp]:
    """The device's operations (kernels, copies, fills) of a finished
    ``torch.profiler.profile``, by start time."""
    from torch.autograd import DeviceType
    ops = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
            s = e.start_ns()
            ops.append(DeviceOp(e.name(), s, s + e.duration_ns()))
    ops.sort(key=lambda o: o.start_ns)
    return ops


def busy_intervals(ops: List[DeviceOp], t0: int,
                   t1: int) -> List[Tuple[int, int]]:
    """The union of the operations' intervals, clipped to [t0, t1)."""
    out: List[Tuple[int, int]] = []
    for o in ops:
        s, e = max(o.start_ns, t0), min(o.end_ns, t1)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


@dataclass
class Timeline:
    """A traced window: its operations, its bounds on the trace's clock
    and the benchmark's spans."""
    ops: List[DeviceOp]
    t0: int
    t1: int
    spans: Spans

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def busy_s(self) -> float:
        return sum(e - s for s, e in busy_intervals(self.ops, self.t0,
                                                    self.t1)) / 1e9

    def kernels(self, symbol: str) -> List[DeviceOp]:
        return [o for o in self.ops if symbol in o.name
                and o.start_ns >= self.t0 and o.start_ns < self.t1]

    def by_name(self, top: int = 10) -> List[list]:
        """The device operations that took most time: [name, seconds]."""
        acc: Dict[str, float] = {}
        for o in self.ops:
            if self.t0 <= o.start_ns < self.t1:
                acc[o.name] = acc.get(o.name, 0.0) + o.seconds
        return [[n, s] for n, s in sorted(acc.items(),
                                          key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[list]:
        """The idle time of the window summed by the span that was open at
        each gap's middle: [span, seconds], the most first."""
        acc: Dict[str, float] = {}
        last = self.t0
        for s, e in busy_intervals(self.ops, self.t0, self.t1) + \
                [(self.t1, self.t1)]:
            if s > last:
                name = self.spans.innermost_at((last + s) // 2)
                acc[name] = acc.get(name, 0.0) + (s - last) / 1e9
            last = max(last, e)
        return [[n, s] for n, s in sorted(acc.items(),
                                          key=lambda kv: -kv[1])[:top]]

    def idle_share(self) -> Optional[float]:
        """Percent of the window in which the card ran nothing."""
        if not self.window_s > 0:
            return None
        return 100.0 * (1.0 - self.busy_s() / self.window_s)

"""The benchmark's own spans: named host intervals around its calls into
the program, on the clock the profiler's trace uses (``time.time_ns``,
the epoch in nanoseconds), so a gap in the device timeline can be named
by the span that was open over it."""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import List, Tuple


class Spans:
    def __init__(self):
        #: (name, start ns, end ns), in the order they closed
        self.done: List[Tuple[str, int, int]] = []

    @contextmanager
    def span(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.done.append((name, t0, time.time_ns()))

    def total_s(self, name: str) -> float:
        return sum(e - s for n, s, e in self.done if n == name) / 1e9

    def count(self, name: str) -> int:
        return sum(1 for n, _, _ in self.done if n == name)

    def innermost_at(self, t_ns: int) -> str:
        """The shortest span open at ``t_ns``, or ``"no span"``."""
        best, width = "no span", None
        for n, s, e in self.done:
            if s <= t_ns < e and (width is None or e - s < width):
                best, width = n, e - s
        return best

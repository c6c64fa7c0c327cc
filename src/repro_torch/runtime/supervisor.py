"""Fault-tolerance harness: step supervision, straggler detection, restart.

Synapse closes the loop here: the predictor's TTC estimate for the profiled
step becomes the straggler deadline (deadline = predicted-or-EMA step time ×
tolerance).  The supervisor:

  * runs steps through a watchdog; a step exceeding its deadline is a
    straggler event (on a real pod: re-slice the mesh / evict the host;
    here: recorded + pluggable callback),
  * catches step failures (injected via ``FailurePlan`` in tests/benches,
    or real exceptions), restores the last committed checkpoint, rebuilds
    on the surviving mesh (elastic re-layout via CheckpointManager's
    unsharded manifest + new shardings), and replays,
  * checkpoints every ``ckpt_every`` steps, asynchronously.

This is the single-process skeleton of the multi-controller loop: at scale
each host runs this supervisor; coordination happens through the checkpoint
store and the (external) scheduler.

A step's time stops only after the device has finished the step (a
synchronise on its loss's stream): on a card the step returns before its
work is done, and the straggler EMA would otherwise measure launch time.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.device import sync


class InjectedFailure(RuntimeError):
    pass


@dataclass
class FailurePlan:
    """Deterministic failure injection for tests/benchmarks."""
    fail_at_steps: Dict[int, str] = field(default_factory=dict)  # step->kind
    fired: set = field(default_factory=set)

    def check(self, step: int):
        if step in self.fail_at_steps and step not in self.fired:
            self.fired.add(step)
            raise InjectedFailure(f"{self.fail_at_steps[step]}@{step}")


@dataclass
class SupervisorConfig:
    ckpt_every: int = 50
    keep: int = 3
    straggler_tolerance: float = 3.0     # × expected step time
    predicted_step_s: Optional[float] = None   # from Synapse predictor
    ema_alpha: float = 0.2
    max_restarts: int = 5


@dataclass
class SupervisorReport:
    steps_run: int = 0
    restarts: int = 0
    straggler_events: List[Dict] = field(default_factory=list)
    failures: List[str] = field(default_factory=list)
    restored_from: List[int] = field(default_factory=list)
    step_times: List[float] = field(default_factory=list)


class Supervisor:
    def __init__(self, ckpt: CheckpointManager, cfg: SupervisorConfig,
                 on_straggler: Optional[Callable[[Dict], None]] = None):
        self.ckpt = ckpt
        self.cfg = cfg
        self.on_straggler = on_straggler
        self.report = SupervisorReport()
        self._ema: Optional[float] = cfg.predicted_step_s

    # -- straggler detection ---------------------------------------------------

    def _deadline(self) -> Optional[float]:
        base = self._ema if self._ema is not None else \
            self.cfg.predicted_step_s
        return None if base is None else base * self.cfg.straggler_tolerance

    def _observe(self, dt: float, step: int):
        self.report.step_times.append(dt)
        dl = self._deadline()
        if dl is not None and dt > dl:
            ev = {"step": step, "duration_s": dt, "deadline_s": dl}
            self.report.straggler_events.append(ev)
            if self.on_straggler:
                self.on_straggler(ev)
        a = self.cfg.ema_alpha
        self._ema = dt if self._ema is None else (1 - a) * self._ema + a * dt

    # -- main loop ---------------------------------------------------------------

    def run(self, *, state, step_fn, batch_fn, num_steps: int,
            start_step: int = 0, failure_plan: Optional[FailurePlan] = None,
            restore_fn: Optional[Callable[[int], Any]] = None,
            extra_fn: Optional[Callable[[int], Dict]] = None):
        """Runs ``num_steps`` with checkpoint/restart.

        step_fn(state, batch) -> (state, metrics);  batch_fn(step) -> batch;
        restore_fn(step) -> state (defaults to CheckpointManager.restore).
        """
        step = start_step
        restarts = 0
        metrics = {}
        while step < start_step + num_steps:
            try:
                if failure_plan is not None:
                    failure_plan.check(step)
                t0 = time.perf_counter()
                state, metrics = step_fn(state, batch_fn(step))
                sync(metrics.get("loss"))    # the device finished the step
                self._observe(time.perf_counter() - t0, step)
                self.report.steps_run += 1
                step += 1
                if step % self.cfg.ckpt_every == 0:
                    extra = {"step": step}
                    if extra_fn:
                        extra.update(extra_fn(step))
                    self.ckpt.save_async(step, state, extra)
            except Exception as e:  # noqa: BLE001 — restart path
                self.report.failures.append(f"{type(e).__name__}: {e}")
                restarts += 1
                self.report.restarts = restarts
                if restarts > self.cfg.max_restarts:
                    raise
                self.ckpt.wait()
                last = self.ckpt.latest_step()
                if last is None:
                    # no checkpoint yet: restart from the caller's initial state
                    step = start_step
                    continue
                state = None     # free the failed run's state first
                if restore_fn is not None:
                    state = restore_fn(last)
                else:
                    state, _ = self.ckpt.restore(last)
                self.report.restored_from.append(last)
                step = last
        self.ckpt.wait()
        return state, metrics


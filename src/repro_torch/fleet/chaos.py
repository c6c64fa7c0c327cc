"""Deterministic fault injection for fleet runs: the chaos engine.

Recovery machinery that is only ever exercised by ad-hoc SIGKILLs in
tests is anecdote, not property.  ``ChaosPolicy`` turns "recovery works"
into a *seeded, replayable* experiment: one picklable policy travels in
the ``WorkerSpec`` to every worker process and host agent, each actor
derives its own deterministic RNG stream from ``(seed, scope)``, and the
same policy + seed therefore reproduces the same fault sequence on the
thread, process, and remote paths — which is what lets tests and the
``bench_fleet.chaos`` benchmark assert exact totals and exact death
counts *under* injected faults.

Fault kinds (all opt-in, all schedulable):

  worker-side (``scope="worker:<spawn ordinal>"``, consulted once per
  dispatched bundle, ordinals are per-actor and 1-based):

    * ``kill_every`` / ``kill_prob`` — die (``os._exit``) *before*
      replying, so the coordinator requeues the in-flight bundle and the
      attempt/poison budget is exercised;
    * ``kill_on_init``   — die before building the emulator: the
      crash-loop breaker's test vector (a worker spec that can never
      come up);
    * ``hang_nth``       — go silent for ``hang_s``: stop heartbeating
      and stop serving, with the pipe still open.  This is the failure
      mode plain I/O-error liveness cannot see — only the heartbeat
      watermark reaps it;
    * ``fail_nth``       — reply ``("err", ...)``: a poison-ish bundle
      failure, the ``on_failure="skip"`` test vector;
    * ``delay_every`` / ``delay_s`` — straggler injection: sleep
      (jittered by the scoped RNG) before replying, the speculative
      re-dispatch test vector.

  agent-side (``scope="agent"``, consulted once per proxied reply):

    * ``drop_agent_after``   — close the coordinator connection instead
      of sending the Nth reply (abrupt agent loss mid-result);
    * ``corrupt_frame_nth``  — flip bytes in the Nth outbound frame
      payload (the ``framing`` corrupt-stream reap path, end to end).

``max_faults`` caps how many faults one actor fires across all kinds,
so a policy like ``kill_every=3, max_faults=1`` means "every worker
dies exactly once, at its third bundle" — deterministic death counts
with a bounded respawn bill.

Determinism contract: an actor's decision at ordinal ``n`` is a pure
function of ``(policy, scope, n)`` — the RNG is seeded from a stable
hash (not Python's salted ``hash``), and every probabilistic knob draws
exactly once per ordinal whether or not it fires, so enabling one fault
kind never shifts another kind's stream.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from random import Random
from typing import List, Optional, Tuple, Union

#: worker-side actions an actor may return from ``on_dispatch``
Action = Union[str, Tuple[str, float]]


def derive_seed(seed: int, scope: str) -> int:
    """Stable per-scope RNG seed: must agree across processes and runs
    (``hash()`` is salted per interpreter, so sha256 it is).  Public
    because it is the repo-wide seeding discipline — ``ChaosPolicy``
    scopes its fault streams with it and ``repro_torch.service.arrivals``
    scopes its arrival streams with it, so a chaos-under-load run is
    reproducible end to end from two integers."""
    digest = hashlib.sha256(f"{seed}:{scope}".encode()).digest()
    return int.from_bytes(digest[:8], "big")


#: backwards-compatible alias (pre-service name)
_derive_seed = derive_seed


@dataclass(frozen=True)
class ChaosPolicy:
    """Picklable, seeded schedule of faults for one fleet run.

    Ship it in ``WorkerSpec.chaos`` (or ``FleetConfig.process(...,
    chaos=...)``) and every worker/agent spawned from that spec injects
    its scheduled faults; pass the same policy again and the same faults
    fire at the same per-actor ordinals.
    """

    seed: int = 0
    # -- worker-side schedules (per-dispatch ordinals, 1-based) -------------
    kill_every: Optional[int] = None     # die before replying to every Nth
    kill_prob: float = 0.0               # seeded per-dispatch death chance
    kill_on_init: bool = False           # die before the emulator builds
    hang_nth: Optional[int] = None       # go silent (no reply/heartbeat)...
    hang_s: float = 3600.0               # ...for this long, on the Nth
    fail_nth: Optional[int] = None       # reply ("err", ...) on the Nth
    delay_every: Optional[int] = None    # straggle on every Nth...
    delay_s: float = 0.0                 # ...by ~this (jittered 0.5x-1.5x)
    # -- agent-side schedules (per-reply ordinals, 1-based) -----------------
    drop_agent_after: Optional[int] = None   # vanish instead of Nth reply
    corrupt_frame_nth: Optional[int] = None  # mangle the Nth reply frame
    # -- budget --------------------------------------------------------------
    max_faults: Optional[int] = None     # per-actor cap across all kinds

    def __post_init__(self):
        for name in ("kill_every", "hang_nth", "fail_nth", "delay_every",
                     "drop_agent_after", "corrupt_frame_nth"):
            v = getattr(self, name)
            if v is not None and v < 1:
                raise ValueError(f"ChaosPolicy.{name} must be >= 1 (it is a "
                                 f"1-based ordinal/interval), got {v}")
        if not 0.0 <= self.kill_prob <= 1.0:
            raise ValueError(f"kill_prob must be in [0, 1], "
                             f"got {self.kill_prob}")
        if self.delay_s < 0 or self.hang_s < 0:
            raise ValueError("delay_s/hang_s must be >= 0")
        if self.max_faults is not None and self.max_faults < 0:
            raise ValueError("max_faults must be >= 0")

    @property
    def active(self) -> bool:
        """Does this policy schedule any fault at all?"""
        return any((self.kill_every, self.kill_prob, self.kill_on_init,
                    self.hang_nth, self.fail_nth, self.delay_every,
                    self.drop_agent_after, self.corrupt_frame_nth))

    def actor(self, scope: str) -> "ChaosActor":
        """One deterministic fault stream for one actor (worker/agent)."""
        return ChaosActor(self, scope)

    def rng(self, scope: str) -> Random:
        """A chaos-safe seeded RNG for non-actor consumers (e.g. the
        coordinator's respawn-backoff jitter) — same seed, same stream."""
        return Random(_derive_seed(self.seed, scope))

    def corrupt_bytes(self, payload: bytes) -> bytes:
        """Deterministically mangle a frame payload (XOR a byte run in
        the middle) — length is preserved so the corruption surfaces as
        an unpicklable frame, not a truncated one."""
        if not payload:
            return payload
        buf = bytearray(payload)
        start = len(buf) // 3
        for i in range(start, min(start + 16, len(buf))):
            buf[i] ^= 0xA5
        return bytes(buf)


class ChaosActor:
    """Per-actor fault stream: counts its own dispatch/reply ordinals and
    answers "what fault fires now?" deterministically.

    ``trace`` records ``(ordinal, action)`` for every fault fired — the
    reproducibility tests compare traces across identically-seeded
    actors.
    """

    def __init__(self, policy: ChaosPolicy, scope: str):
        self.policy = policy
        self.scope = scope
        self.rng = policy.rng(scope)
        self.dispatches = 0
        self.replies = 0
        self.faults = 0
        self.trace: List[Tuple[int, Action]] = []

    def _fire(self, ordinal: int, action: Action) -> Optional[Action]:
        if self.policy.max_faults is not None \
                and self.faults >= self.policy.max_faults:
            return None
        self.faults += 1
        self.trace.append((ordinal, action))
        return action

    def on_dispatch(self) -> Optional[Action]:
        """Consulted once per bundle a worker is asked to replay.

        Returns ``None`` (serve normally), ``"kill"``, ``"fail"``,
        ``("hang", seconds)``, or ``("delay", seconds)``.  Every
        probabilistic knob draws from the RNG on every call so the
        stream stays ordinal-aligned regardless of which faults fire.
        """
        p = self.policy
        self.dispatches += 1
        n = self.dispatches
        kill_draw = self.rng.random()            # always drawn: alignment
        delay_jitter = 0.5 + self.rng.random()   # always drawn: alignment
        if p.fail_nth is not None and n == p.fail_nth:
            return self._fire(n, "fail")
        if p.hang_nth is not None and n == p.hang_nth:
            return self._fire(n, ("hang", p.hang_s))
        if p.kill_every is not None and n % p.kill_every == 0:
            return self._fire(n, "kill")
        if p.kill_prob and kill_draw < p.kill_prob:
            return self._fire(n, "kill")
        if p.delay_every is not None and n % p.delay_every == 0:
            return self._fire(n, ("delay", p.delay_s * delay_jitter))
        return None

    def on_reply(self) -> Optional[str]:
        """Consulted once per reply an agent proxies back to the
        coordinator.  Returns ``None``, ``"corrupt"`` (mangle this
        frame), or ``"drop"`` (close the connection instead of sending).
        """
        p = self.policy
        self.replies += 1
        n = self.replies
        if p.drop_agent_after is not None and n > p.drop_agent_after:
            return self._fire(n, "drop")
        if p.corrupt_frame_nth is not None and n == p.corrupt_frame_nth:
            return self._fire(n, "corrupt")
        return None

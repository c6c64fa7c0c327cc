"""The seeded traffic generator every mix is read by.

A mix file (``traffic/<mix>.json``) gives the sizes of its requests as
distributions and how many requests make one cycle.  A cycle holds the
same requests for every seed: its prompt and output lengths are the
distributions' quantiles at ``(i + 0.5) / n`` for ``i < n`` (stratified
draws), prompts and outputs paired by a fixed stride through the
quantiles, and the requests split into fixed groups of ``group`` (the
waves of a static batch).  The seed orders them: each cycle it shuffles
the groups and the requests inside each group.  So every seed sends the
same amount of work, in another order, and two runs of one seed send the
same requests in the same order.

A distribution is ``{"dist": "fixed", "value": v}`` or ``{"dist":
"loguniform", "min": a, "max": b}``, with an optional ``"round_up": m``
that rounds a length up to a multiple of ``m``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Iterator, List

import numpy as np


@dataclass(frozen=True)
class Request:
    index: int           # position in the stream, from 0
    prompt: int          # prompt tokens
    output: int          # output tokens (the first comes from the prefill)
    group: int           # which wave of the stream it arrives in


def _quantile(dist: Dict, q: float) -> int:
    kind = dist["dist"]
    if kind == "fixed":
        v = float(dist["value"])
    elif kind == "loguniform":
        lo, hi = math.log(dist["min"]), math.log(dist["max"])
        v = math.exp(lo + q * (hi - lo))
    else:
        raise ValueError(f"unknown distribution {kind!r}")
    m = int(dist.get("round_up", 1))
    return int(math.ceil(round(v, 6) / m) * m)


def _stride(n: int) -> int:
    """A stride coprime to ``n`` near ``n / 2.618``: consecutive quantiles
    land far apart, so pairs and groups mix short with long."""
    s = max(1, round(n / 2.618))
    while math.gcd(s, n) != 1:
        s += 1
    return s


def cycle(mix: Dict) -> List[List[tuple]]:
    """The cycle's groups of (prompt, output) lengths, the same for every
    seed."""
    n = int(mix["cycle"])
    group = int(mix.get("group", 1))
    if n % group:
        raise ValueError(f"a cycle of {n} does not split into groups of "
                         f"{group}")
    qs = [(i + 0.5) / n for i in range(n)]
    prompts = [_quantile(mix["prompt"], q) for q in qs]
    outputs = [_quantile(mix["output"], q) for q in qs]
    s = _stride(n)
    order = [(i * s) % n for i in range(n)]
    reqs = [(prompts[order[i]], outputs[(order[i] * s) % n])
            for i in range(n)]
    return [reqs[g:g + group] for g in range(0, n, group)]


def stream(mix: Dict, seed: int) -> Iterator[Request]:
    """The requests of ``mix`` under ``seed``, cycle after cycle."""
    rng = np.random.default_rng(seed)
    groups = cycle(mix)
    index = wave = 0
    while True:
        for gi in rng.permutation(len(groups)):
            members = groups[gi]
            for mi in rng.permutation(len(members)):
                p, o = members[mi]
                yield Request(index=index, prompt=p, output=o, group=wave)
                index += 1
            wave += 1


def shapes(mix: Dict) -> List[tuple]:
    """The distinct (prompt, output) lengths of a cycle, shortest first."""
    return sorted({r for g in cycle(mix) for r in g})


def token_ids(seed: int, index: int, length: int, vocab: int) -> np.ndarray:
    """The prompt of request ``index`` of a stream under ``seed``: token
    ids uniform over the vocabulary, drawn from the seed and the index
    alone, so the same request gets the same tokens in every run."""
    rng = np.random.default_rng([seed, index])
    return rng.integers(0, vocab, size=length, dtype=np.int64)

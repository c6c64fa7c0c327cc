"""Critical-path accounting for dependency-structured fleet runs.

A DAG run's product is its *tail*, not its totals: the makespan is gated
by the longest dependency chain of replay work, and aggregate metrics
hide exactly that (Cornebize & Legrand, arXiv 2102.07674).
``critical_path`` turns the ``BundleTiming`` stamps ``FleetBase.stream``
already records into the numbers that expose it:

* ``critical_path_s`` — the longest path of replay work through the DAG
  (the lower bound no amount of extra workers can beat);
* ``makespan_s`` — observed wall span, first enqueue to last done;
* ``sum_work_s`` — total replay work (the serial lower bound);
* ``parallelism`` — ``sum_work_s / makespan_s``, the achieved overlap;
* ``slack_s`` — per node: how much that node's replay could grow before
  it joins the critical path (0.0 for nodes already on it);
* ``critical_nodes`` — one longest path, root to leaf (ties broken
  toward the smallest index, so the result is deterministic).

All figures derive from ``BundleTiming.replay_s`` (dispatch → done of
the *last* attempt), so a chaos requeue charges queue time — never
replay time — and the critical path stays an honest work metric under
faults.  Skipped bundles carry zero replay work and simply pass their
parents' finish time through.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Sequence, Tuple


def validate_parents(idx: int, parents: Sequence[int],
                     command: str = "") -> Tuple[int, ...]:
    """The frontier scheduler's edge contract: parents must reference
    *earlier* stream indices.  Indices are assigned in arrival order, so
    a forward or self reference is the only way to express a cycle (or a
    parent that can never arrive) — both fail loudly here, up front,
    instead of deadlocking the stream."""
    parents = tuple(parents)
    bad = sorted({p for p in parents
                  if not isinstance(p, int) or isinstance(p, bool)
                  or p < 0 or p >= idx})
    if bad:
        what = f" ({command!r})" if command else ""
        raise ValueError(
            f"bundle {idx}{what} depends on {bad}: parents must reference "
            "earlier bundles in the stream (indices are assigned in "
            "arrival order, so forward or self references are "
            "unsatisfiable — a cycle or a parent that never arrives)")
    if len(set(parents)) != len(parents):
        raise ValueError(f"bundle {idx} repeats a parent: {parents}")
    return parents


def critical_path(parents: Mapping[int, Sequence[int]],
                  timings: Mapping[int, "BundleTiming"]) -> Dict:
    """Longest-path analysis of one DAG run from its per-bundle stamps.

    ``parents`` maps node index -> parent indices (topological by the
    stream contract: every parent index is smaller).  ``timings`` maps
    node index -> ``BundleTiming``.  Nodes present in ``parents`` but
    missing from ``timings`` (a raised run's unfinished tail) are
    ignored; edges into missing nodes are dropped.  Returns ``{}`` when
    there is nothing to account."""
    nodes = sorted(timings)
    if not nodes:
        return {}
    idxset = set(nodes)
    par = {i: tuple(p for p in parents.get(i, ()) if p in idxset)
           for i in nodes}
    kids: Dict[int, List[int]] = {i: [] for i in nodes}
    for i in nodes:
        for p in par[i]:
            kids[p].append(i)
    work = {i: max(0.0, float(timings[i].replay_s)) for i in nodes}
    # forward pass (ascending == topological): longest work path ENDING
    # at each node, inclusive
    finish: Dict[int, float] = {}
    for i in nodes:
        finish[i] = work[i] + max((finish[p] for p in par[i]), default=0.0)
    # backward pass: longest work path STARTING at each node, inclusive
    tail: Dict[int, float] = {}
    for i in reversed(nodes):
        tail[i] = work[i] + max((tail[c] for c in kids[i]), default=0.0)
    cp = max(finish.values())
    # slack: how far the longest path THROUGH this node sits under the
    # critical path (floored at 0 against float noise)
    slack = {i: max(0.0, cp - (finish[i] + tail[i] - work[i]))
             for i in nodes}
    # walk one critical path, root to leaf, smallest index on ties
    leaf = min(i for i in nodes if finish[i] == cp)
    path = [leaf]
    cur = leaf
    while par[cur]:
        best = max(finish[p] for p in par[cur])
        cur = min(p for p in par[cur] if finish[p] == best)
        path.append(cur)
    path.reverse()
    makespan = (max(t.done for t in timings.values())
                - min(t.enqueued for t in timings.values()))
    sum_work = sum(work.values())
    return {
        "critical_path_s": cp,
        "makespan_s": max(0.0, makespan),
        "sum_work_s": sum_work,
        "parallelism": (sum_work / makespan) if makespan > 0 else 0.0,
        "critical_nodes": path,
        "slack_s": slack,
        "n_nodes": len(nodes),
        "n_edges": sum(len(par[i]) for i in nodes),
    }

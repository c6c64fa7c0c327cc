"""Scenario algebra: compose ``SynapseProfile``s, and structure them as DAGs.

Every scenario generator emits one linear profile; real distributed
workloads are *dependency-structured* — fork-join diamonds, deep chains,
fanout with cross-profile edges — and their product is tail latency, not
totals (ROADMAP item 4; Cornebize & Legrand, arXiv 2102.07674, on why
aggregate means hide exactly the straggler effects a critical path
exposes).  This module supplies both halves:

* **profile operators** — pure functions over ``SynapseProfile``s:

    - ``concat(a, b, ...)``   sequential composition: samples appended in
      order, indices re-stamped 0..n-1 (associative — the sample list of
      ``concat(a, concat(b, c))`` is identical to
      ``concat(concat(a, b), c)``);
    - ``overlay(a, b, ...)``  parallel composition: samplewise resource
      sum, missing tails treated as zero (commutative — field-wise float
      addition commutes bitwise, so ``overlay(a, b)`` and
      ``overlay(b, a)`` agree sample by sample);
    - ``scale(p, f)``         per-sample resource scaling (the straggler
      knob: one branch scaled is a seeded tail outlier).

* **the DAG workload model** — ``WorkloadDag``: an ordered list of
  ``DagNode(profile, parents)`` where parents index *earlier* nodes, so
  every dag is topologically ordered by construction and cycles are
  unrepresentable.  ``chain(...)`` and ``fork_join(...)`` build the two
  canonical shapes (the ``chain``/``dag`` patterns of
  iocane-ai/synthetic-agents that expose "death by a thousand cuts" and
  straggler-hidden-by-aggregates failure modes).  A ``WorkloadDag`` feeds
  straight into ``Emulator.emulate_many`` (process/remote executors):
  each node becomes a ``ScheduleBundle`` whose ``parents`` edges gate its
  dispatch in ``FleetBase.stream``'s frontier scheduler, and the run's
  ``FleetReport.dag`` carries critical-path accounting.

``linearize()`` folds a dag back into one concatenated profile (nodes in
index order) with the structure recorded under ``meta["dag"]`` — the
registry-compatible single-profile view ``repro_torch.scenarios.dag`` uses, and
the equivalence anchor: an edge-free dag replays to exactly the same
totals as its linearized profile stream.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Sequence, Tuple

from repro_torch.core.metrics import ResourceVector, Sample, SynapseProfile


def _restamp(samples: Iterable[Sample]) -> List[Sample]:
    """Copy samples with indices re-stamped 0..n-1 (the registry's
    well-formedness contract)."""
    return [Sample(index=i, resources=s.resources, duration_s=s.duration_s,
                   label=s.label)
            for i, s in enumerate(samples)]


def concat(*profiles: SynapseProfile, command: str = "") -> SynapseProfile:
    """Sequential composition: ``a`` then ``b`` then ... as one profile.

    Associative on samples and totals: only the indices are re-stamped,
    so any parenthesization yields the identical sample list.
    """
    if not profiles:
        raise ValueError("concat needs at least one profile")
    samples: List[Sample] = []
    for p in profiles:
        samples.extend(p.samples)
    return SynapseProfile(
        command=command or "concat:" + "+".join(p.command for p in profiles),
        samples=_restamp(samples))


def overlay(*profiles: SynapseProfile, command: str = "") -> SynapseProfile:
    """Parallel composition: samplewise resource sum, zero-padded tails.

    Sample ``i`` of the overlay consumes the sum of every operand's
    sample ``i`` — two workloads sharing a host, expressed as one
    profile.  Commutative: ``ResourceVector.add`` is field-wise float
    addition, so operand order never changes a bit (and operands on
    disjoint resource types compose without interacting at all).
    """
    if not profiles:
        raise ValueError("overlay needs at least one profile")
    n = max(len(p.samples) for p in profiles)
    samples = []
    for i in range(n):
        rv = ResourceVector()
        for p in profiles:
            if i < len(p.samples):
                rv = rv.add(p.samples[i].resources)
        samples.append(Sample(index=i, resources=rv))
    return SynapseProfile(
        command=command or "overlay:" + "+".join(p.command for p in profiles),
        samples=samples)


def scale(profile: SynapseProfile, factor: float, *,
          command: str = "") -> SynapseProfile:
    """Scale every sample's resources by ``factor`` (>= 0).

    The straggler knob: ``scale(branch, 6.0)`` is a branch doing 6x the
    work — the tail outlier a dag's critical path exposes and aggregate
    totals hide.
    """
    if not (factor >= 0.0):
        raise ValueError(f"scale factor must be >= 0, got {factor!r}")
    return SynapseProfile(
        command=command or f"scale[{factor:g}]:{profile.command}",
        samples=[Sample(index=s.index, resources=s.resources.scale(factor),
                        duration_s=s.duration_s, label=s.label)
                 for s in profile.samples])


# ---------------------------------------------------------------------------
# the DAG workload model
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class DagNode:
    """One dag node: a profile plus the indices of the nodes whose results
    must land before this one may dispatch."""
    profile: SynapseProfile
    parents: Tuple[int, ...] = ()


@dataclass
class WorkloadDag:
    """An ordered, topologically-sorted dependency-structured workload.

    Nodes are appended with ``add``; parents must index earlier nodes, so
    the list order *is* a topological order and forward/self references
    (the only way to express a cycle) are rejected at construction —
    the same contract ``FleetBase.stream`` enforces per-bundle.
    """
    nodes: List[DagNode] = field(default_factory=list)

    def __post_init__(self):
        for i, node in enumerate(self.nodes):
            self._check(i, node.parents)

    def _check(self, idx: int, parents: Sequence[int]) -> None:
        bad = sorted({p for p in parents
                      if not isinstance(p, int) or p < 0 or p >= idx})
        if bad:
            raise ValueError(
                f"dag node {idx} lists parent(s) {bad}: parents must index "
                "earlier nodes (0..idx-1) — forward or self references "
                "would be unsatisfiable cycles")
        if len(set(parents)) != len(parents):
            raise ValueError(f"dag node {idx} repeats a parent: {parents}")

    def add(self, profile: SynapseProfile,
            parents: Sequence[int] = ()) -> int:
        """Append a node; returns its index (usable as a later parent)."""
        parents = tuple(parents)
        self._check(len(self.nodes), parents)
        self.nodes.append(DagNode(profile=profile, parents=parents))
        return len(self.nodes) - 1

    def __len__(self) -> int:
        return len(self.nodes)

    @property
    def parents_map(self) -> Dict[int, Tuple[int, ...]]:
        return {i: n.parents for i, n in enumerate(self.nodes)}

    @property
    def n_edges(self) -> int:
        return sum(len(n.parents) for n in self.nodes)

    def profiles(self) -> List[SynapseProfile]:
        return [n.profile for n in self.nodes]

    @property
    def totals(self) -> ResourceVector:
        """Aggregate resources, folded in node-index order — the exact
        analytic expectation an index-order ``ReportFold`` of a dag run
        must reproduce bit-for-bit."""
        t = ResourceVector()
        for n in self.nodes:
            t = t.add(n.profile.totals)
        return t

    def linearize(self, *, command: str = "") -> SynapseProfile:
        """One concatenated profile (nodes in index order), the structure
        preserved under ``meta["dag"]`` so single-profile surfaces
        (predict, in-process emulate, the scenario registry) can carry a
        dag without understanding edges."""
        prof = concat(*[n.profile for n in self.nodes],
                      command=command or "dag:"
                      + "+".join(n.profile.command for n in self.nodes))
        prof.meta["dag"] = {
            "parents": [list(n.parents) for n in self.nodes],
            "nodes": [{"command": n.profile.command,
                       "n_samples": len(n.profile.samples)}
                      for n in self.nodes]}
        return prof


def chain(profiles: Sequence[SynapseProfile]) -> WorkloadDag:
    """Deep chain: node i depends on node i-1 — no parallelism at all,
    makespan == sum of work, every node on the critical path."""
    if not profiles:
        raise ValueError("chain needs at least one profile")
    dag = WorkloadDag()
    prev = None
    for p in profiles:
        prev = dag.add(p, () if prev is None else (prev,))
    return dag


def fork_join(source: SynapseProfile, branches: Sequence[SynapseProfile],
              sink: SynapseProfile) -> WorkloadDag:
    """Fork-join diamond: ``source`` fans out to every branch, ``sink``
    joins them — the sink dispatches only after the slowest branch, so
    one straggler branch gates the makespan while totals look healthy."""
    if not branches:
        raise ValueError("fork_join needs at least one branch")
    dag = WorkloadDag()
    root = dag.add(source)
    mids = [dag.add(b, (root,)) for b in branches]
    dag.add(sink, tuple(mids))
    return dag

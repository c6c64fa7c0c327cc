"""DAG scenarios: fork-join diamonds and deep chains, registry-integrated.

Two first-class dependency-structured workloads (the iocane-ai/
synthetic-agents ``dag``/``chain`` shapes):

* ``dag_diamond`` — a planner fans out to ``fanout`` parallel branches
  and a reducer joins them.  One seeded straggler branch does
  ``straggler_factor``x the work, so the join (and therefore the
  makespan) is gated on it while aggregate totals look healthy —
  straggler-hidden-by-aggregates, exposed by critical-path accounting.
* ``deep_chain`` — ``depth`` strictly sequential stages, optionally
  decaying in size.  Zero parallelism: every stage is on the critical
  path, and per-stage overheads compound ("death by a thousand cuts").

Each shape exists in two forms.  ``dag_diamond_workload`` /
``deep_chain_workload`` build the real multi-node ``WorkloadDag`` (feed
it to ``Emulator.emulate_many`` on a process/remote fleet for
frontier-scheduled replay with ``FleetReport.dag`` critical-path
metrics).  The registered scenarios return that dag *linearized* — one
concatenated profile, nodes in topological order, edges preserved under
``meta["dag"]`` — so the registry contract (one validated
``SynapseProfile``) holds and single-profile surfaces (predict,
in-process emulate, the store) work unchanged.  The two views are
total-equivalent by construction: the linearized profile's totals equal
the workload's node-index-order fold bit for bit.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.metrics import ResourceVector, Sample, SynapseProfile
from repro_torch.scenarios.algebra import (WorkloadDag, chain, fork_join,
                                           scale)
from repro_torch.scenarios.base import register


def _stage(command: str, flops: float, hbm: float, samples: int,
           label: str = "") -> SynapseProfile:
    return SynapseProfile(
        command=command,
        samples=[Sample(index=i,
                        resources=ResourceVector(flops=flops, hbm_bytes=hbm),
                        label=label)
                 for i in range(samples)])


def dag_diamond_workload(fanout: int = 4, work_flops: float = 5e7,
                         work_hbm: float = 8e6, samples_per: int = 2,
                         straggler_factor: float = 4.0,
                         straggler_index: int = -1,
                         seed: int = 0) -> WorkloadDag:
    """Fork-join diamond as a ``WorkloadDag``: source -> ``fanout``
    branches (one seeded straggler) -> sink."""
    if fanout < 1 or samples_per < 1:
        raise ValueError("dag_diamond needs fanout >= 1 and samples_per >= 1")
    if straggler_factor < 1.0:
        raise ValueError("straggler_factor must be >= 1")
    rng = np.random.default_rng(seed)
    idx = straggler_index if 0 <= straggler_index < fanout \
        else int(rng.integers(fanout))
    source = _stage("dag:diamond:source", work_flops, work_hbm, samples_per,
                    label="source")
    branches = []
    for i in range(fanout):
        b = _stage(f"dag:diamond:branch{i}", work_flops, work_hbm,
                   samples_per, label="straggler" if i == idx else "branch")
        if i == idx and straggler_factor > 1.0:
            b = scale(b, straggler_factor, command=b.command)
        branches.append(b)
    sink = _stage("dag:diamond:sink", work_flops, work_hbm, samples_per,
                  label="sink")
    dag = fork_join(source, branches, sink)
    return dag


def deep_chain_workload(depth: int = 6, work_flops: float = 5e7,
                        work_hbm: float = 8e6, samples_per: int = 2,
                        decay: float = 1.0) -> WorkloadDag:
    """Deep chain as a ``WorkloadDag``: ``depth`` sequential stages, stage
    k scaled by ``decay**k`` (decay < 1 models shrinking pipeline
    stages)."""
    if depth < 1 or samples_per < 1:
        raise ValueError("deep_chain needs depth >= 1 and samples_per >= 1")
    if not (decay > 0.0):
        raise ValueError(f"decay must be > 0, got {decay!r}")
    stages = []
    for k in range(depth):
        s = _stage(f"dag:chain:stage{k}", work_flops, work_hbm, samples_per,
                   label=f"stage{k}")
        if decay != 1.0:
            s = scale(s, decay ** k, command=s.command)
        stages.append(s)
    return chain(stages)


@register("dag_diamond", fanout=4, work_flops=5e7, work_hbm=8e6,
          samples_per=2, straggler_factor=4.0, straggler_index=-1, seed=0)
def dag_diamond(fanout, work_flops, work_hbm, samples_per,
                straggler_factor, straggler_index, seed) -> SynapseProfile:
    """Fork-join diamond with one seeded straggler branch (linearized)."""
    dag = dag_diamond_workload(fanout=fanout, work_flops=work_flops,
                               work_hbm=work_hbm, samples_per=samples_per,
                               straggler_factor=straggler_factor,
                               straggler_index=straggler_index, seed=seed)
    prof = dag.linearize(command="scenario:dag_diamond")
    prof.meta["fanout"] = fanout
    return prof


@register("deep_chain", depth=6, work_flops=5e7, work_hbm=8e6,
          samples_per=2, decay=1.0)
def deep_chain(depth, work_flops, work_hbm, samples_per,
               decay) -> SynapseProfile:
    """Deep sequential chain — zero parallelism, all critical path
    (linearized)."""
    dag = deep_chain_workload(depth=depth, work_flops=work_flops,
                              work_hbm=work_hbm, samples_per=samples_per,
                              decay=decay)
    prof = dag.linearize(command="scenario:deep_chain")
    prof.meta["depth"] = depth
    return prof

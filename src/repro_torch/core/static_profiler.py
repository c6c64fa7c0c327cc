"""Black-box step profiler ("static watcher family") on PyTorch.

The counterpart of the JAX package's ``core/static_profiler.py``.  PyTorch
compiles nothing ahead of a run, so ``profile_step`` runs the step once
under ``op_analysis.OpCounter``, which supplies the resource consumption
(flops, dot bytes, collective wire bytes) that the JAX package reads from
a compiled module, and the layer loops' trips supply the *sample sequence*
as the entry computation's scans do there.  Granularities:

  * "step"  — a single sample for the whole step
  * "scan"  — samples follow program structure (default; the layer loop
              becomes L ordered samples, glue between them)

The run happens on the card by default, on the CPU when asked, or on meta
tensors (``device="meta"``): shapes only, no launch and no memory, and
the same counts as a run on real tensors.  ``profile_traced`` builds the
profile from a counter that already ran.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils._pytree import tree_leaves, tree_map

from repro_torch.core import op_analysis
from repro_torch.core.metrics import ResourceVector, Sample, SynapseProfile
from repro_torch.device import DeviceLike, resolve
from repro_torch.obs import clock as obs_clock

GRANULARITIES = ("step", "scan")


def _rv(cost: op_analysis.OpCost) -> ResourceVector:
    """A sample's resources: device bytes are the dots' (the walker's
    default), not the unfused upper bound ``hbm_bytes``."""
    return ResourceVector(flops=cost.flops, hbm_bytes=cost.dot_bytes,
                          ici_bytes=cost.collective_bytes())


def _tensor_bytes(tree) -> int:
    """Bytes of the distinct storages of the tensors in ``tree``."""
    seen: Dict[int, int] = {}
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            seen[st._cdata] = st.nbytes()
    return int(sum(seen.values()))


def profile_traced(counter: op_analysis.OpCounter, *, command: str,
                   tags: Optional[Dict] = None, granularity: str = "scan",
                   mesh=None) -> SynapseProfile:
    """The profile of a finished ``OpCounter`` (``op_analysis.count_ops``):
    its whole cost as one sample ("step") or its ``sample_breakdown``
    ("scan").  The JAX package's ``profile_compiled`` reads the same from
    a compiled module."""
    if granularity not in GRANULARITIES:
        raise ValueError(f"unknown granularity {granularity!r}; choose one "
                         f"of {GRANULARITIES}")
    sysinfo: Dict[str, Any] = {"backend": "torch-static"}
    if mesh is not None:
        sysinfo["mesh"] = {n: int(s) for n, s in
                           zip(mesh.axis_names, mesh.devices.shape)}
        sysinfo["n_devices"] = int(mesh.devices.size)

    samples: List[Sample] = []
    if granularity == "step":
        samples.append(Sample(index=0, resources=_rv(counter.total),
                              label="step"))
    else:
        idx = 0
        for label, cost, count in op_analysis.sample_breakdown(counter):
            rv = _rv(cost)
            for _ in range(count):
                samples.append(Sample(index=idx, resources=rv, label=label))
                idx += 1
    return SynapseProfile(command=command, tags=tags or {}, samples=samples,
                          sysinfo=sysinfo)


def profile_step(fn, *args, command: str, tags=None, mesh=None,
                 granularity: str = "scan", device: DeviceLike = None,
                 ) -> Tuple[SynapseProfile, op_analysis.OpCost]:
    """Run ``fn(*args)`` once under the counter on ``device`` (``"cuda"``
    unless named; ``"cpu"``; ``"meta"``), tensors of ``args`` elsewhere
    moved there first, and profile it.  Returns ``(profile, cost)``, the
    cost the whole run counted, as the JAX package returns ``(profile,
    compiled)``.

    ``meta["memory"]``: ``argument_bytes`` and ``output_bytes`` from the
    tensors; ``temp_bytes``, the run's peak of device memory above what it
    started with on a card (``torch.cuda.max_memory_allocated``), the
    counter's high-water mark of the bytes the run allocated elsewhere.
    ``meta["trace_s"]`` (the JAX package's ``lower_compile_s``) is the
    run's wall time.  The JAX package's ``xla_cost_flops``, XLA's own cost
    analysis, has no counterpart here: there is no compiler to ask.
    """
    dev = resolve(device)
    args = tree_map(lambda t: t.to(dev) if isinstance(t, torch.Tensor)
                    and t.device != dev else t, args)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = obs_clock.now()
    counter, out = op_analysis.count_ops(fn, *args)
    if on_card:
        torch.cuda.synchronize(dev)
    trace_s = obs_clock.now() - t0
    prof = profile_traced(counter, command=command, tags=tags,
                          granularity=granularity, mesh=mesh)
    temp = (torch.cuda.max_memory_allocated(dev) - base if on_card
            else counter.peak_live_bytes)
    prof.meta["memory"] = {"argument_bytes": _tensor_bytes(args),
                           "temp_bytes": int(temp),
                           "output_bytes": _tensor_bytes(out)}
    prof.meta["trace_s"] = trace_s
    return prof, counter.total

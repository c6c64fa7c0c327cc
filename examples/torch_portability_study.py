"""Paper Fig. 3 live on PyTorch: one profile, several machines, the
dominant resource flips.

The profile is a tiny LM's train step, profiled statically
(``profile_step`` on meta tensors), with a checkpoint-like write after
each step.  It is predicted on the paper's hosts, a TPU v5e and the H100
the port runs on.  The H100's datasheet names no storage rate, so the
card is given this host's own (``calibrate.measure_storage``), a spec
made here and kept out of ``REGISTRY``.

PYTHONPATH=src python examples/torch_portability_study.py [--device cuda|cpu]
"""
import os, sys
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(_ROOT, 'src'), _ROOT]

import argparse
import dataclasses

from repro_torch.core import (H100_SXM, HOST_ARCHER_NODE, HOST_I7_M620,
                              HOST_STAMPEDE_NODE, TPU_V5E, ResourceVector,
                              Sample, SynapseProfile, compare, profile_step)
from repro_torch.core.calibrate import measure_storage
from repro_torch.device import cli_device
from torch_quickstart import (_abstract_batch, _abstract_state,
                              tiny_train_workload)


def _mixed_profile(device, io_mb: float = 16.0, steps: int = 4):
    """A profile with both compute and storage so dominance can flip."""
    _, meta = tiny_train_workload(device, steps=steps)
    prof, _ = profile_step(meta["step"], _abstract_state(meta["model"]),
                           _abstract_batch(meta), command="bench-lm",
                           granularity="scan", device="meta")
    samples = []
    for _ in range(steps):
        for s in prof.samples:
            samples.append(Sample(index=len(samples), resources=s.resources,
                                  label=s.label))
        # checkpoint-like write after each step
        samples.append(Sample(
            index=len(samples),
            resources=ResourceVector(
                storage_write_bytes=io_mb * 1e6 / steps),
            label="ckpt"))
    return SynapseProfile(command="bench-lm+io", samples=samples)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the profiled step runs (default: cuda)")
    args = ap.parse_args()
    dev = cli_device(args.device, "torch_portability_study")
    prof = _mixed_profile(dev, steps=2)
    print(f"profile: {len(prof.samples)} samples, "
          f"flops={prof.totals.flops:.2e}, "
          f"write={prof.totals.storage_write_bytes/1e6:.0f}MB")
    write_bps, _ = measure_storage()
    h100 = dataclasses.replace(H100_SXM, storage_bw=write_bps)
    print(f"h100 storage: this host's measured write rate, "
          f"{write_bps/1e6:.0f} MB/s")
    out = compare(prof, [HOST_I7_M620, HOST_STAMPEDE_NODE, HOST_ARCHER_NODE,
                         TPU_V5E, h100])
    print(f"{'machine':24s} {'ttc_max':>10s} {'ttc_sum':>10s} "
          f"{'dominant':>10s}  per-sample dominance")
    for hw, v in out.items():
        print(f"{hw:24s} {v['ttc_max']:10.4f} {v['ttc_sum']:10.4f} "
              f"{v['dominant_total']:>10s}  {v['dominant_histogram']}")
    doms = {v["dominant_total"] for v in out.values()}
    if len(doms) < 2:
        raise SystemExit("expected the dominant resource to flip")
    print("\nOK: dominant resource flips across machines (paper Fig. 3).")


if __name__ == "__main__":
    main()

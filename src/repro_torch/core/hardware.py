"""Hardware descriptions used as TTC prediction targets.

The paper predicts TTC on machines the user cannot access from a
resource-consumption profile + a hardware description; these specs are that
description.  They are targets for ``predictor.predict``, kept identical to
the JAX package's so both packages predict the same times: a TPU v5e pod
and the paper's CPU hosts.  ``H100_SXM`` describes the card the port runs
on, from its datasheet; it is the port's own and stays out of ``REGISTRY``,
which holds the JAX package's targets.  What the atoms sustain on a device
is measured by ``repro_torch.core.calibrate``.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Optional, Tuple


@dataclass(frozen=True)
class HardwareSpec:
    name: str
    peak_flops: float            # per chip, bf16
    hbm_bw: float                # bytes/s per chip
    ici_bw: float                # bytes/s per link per chip
    ici_links: int = 4           # v5e: 4 links per chip (2D torus x2 dirs)
    mem_per_chip: float = 16e9
    chips: int = 1
    storage_bw: float = 0.0      # host/remote storage bytes/s (0 = ignore)
    # Derated "achievable" fractions (roofline ceilings are theoretical;
    # predictors may apply these):
    flops_derate: float = 1.0
    hbm_derate: float = 1.0
    ici_derate: float = 1.0

    def with_chips(self, n: int) -> "HardwareSpec":
        return replace(self, chips=n)


TPU_V5E = HardwareSpec(
    name="tpu_v5e",
    peak_flops=197e12,           # bf16 per chip (assignment constant)
    hbm_bw=819e9,                # bytes/s (assignment constant)
    ici_bw=50e9,                 # bytes/s per link (assignment constant)
    ici_links=4,
    mem_per_chip=16e9,
)

TPU_V5E_POD = TPU_V5E.with_chips(256)          # 16x16 single pod
TPU_V5E_2POD = TPU_V5E.with_chips(512)         # 2 pods (DCI between pods)

# The paper's experiment hosts, approximated for the portability study
# (bench_emulation_portability): profiles taken on one host are replayed
# against others and the dominant resource flips (paper Fig. 3).
HOST_I7_M620 = HardwareSpec(name="i7_m620", peak_flops=21e9, hbm_bw=17e9,
                            ici_bw=0.0, ici_links=0, mem_per_chip=8e9,
                            storage_bw=200e6)     # Intel 320 SSD
HOST_STAMPEDE_NODE = HardwareSpec(name="stampede_e5_2680", peak_flops=346e9,
                                  hbm_bw=51e9, ici_bw=0.0, ici_links=0,
                                  mem_per_chip=32e9, storage_bw=120e6)  # HDD
HOST_ARCHER_NODE = HardwareSpec(name="archer_e5_2697v2", peak_flops=518e9,
                                hbm_bw=59e9, ici_bw=0.0, ici_links=0,
                                mem_per_chip=64e9, storage_bw=150e6)

# NVIDIA H100 SXM, datasheet figures: the atoms burn float32, so the peak is
# float32 outside the tensor cores (67 TFLOP/s), not the bf16 rate; 3.35 TB/s
# of HBM3, 80 GB; one card, no wire
H100_SXM = HardwareSpec(name="h100_sxm_fp32_datasheet", peak_flops=67e12,
                        hbm_bw=3.35e12, ici_bw=0.0, ici_links=0,
                        mem_per_chip=80e9)

REGISTRY: Dict[str, HardwareSpec] = {
    s.name: s for s in [TPU_V5E, HOST_I7_M620, HOST_STAMPEDE_NODE,
                        HOST_ARCHER_NODE]
}


def get_spec(name: str, chips: int = 1) -> HardwareSpec:
    return REGISTRY[name].with_chips(chips)

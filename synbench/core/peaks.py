"""Published peaks of one NVIDIA H100 SXM (NVIDIA's datasheet, dense rates,
at its 700 W limit).  Every share of a peak or a roofline is taken against
these, with the card's power limit printed beside it."""
from __future__ import annotations

import subprocess

FP32_FLOPS = 67e12           # float32 outside the tensor cores
BF16_FLOPS = 989e12          # bfloat16 on the tensor cores
HBM_BYTES_PER_S = 3.35e12    # HBM3
DATASHEET_WATTS = 700.0


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them, or
    an empty string where it cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return ""
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else ""

"""Entry points used by ``repro_torch.core.atoms.CollectiveAtom`` (backend
``"cuda"``)."""
from __future__ import annotations

import torch

from repro_torch.kernels.collective import kernel


def collective(x: torch.Tensor, *, dim: int, kind: str) -> torch.Tensor:
    """One per-sample collective over the shards ``x``."""
    return kernel.collective(x, dim=dim, kind=kind)


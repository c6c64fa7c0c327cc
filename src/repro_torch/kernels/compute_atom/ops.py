"""Entry point used by ``repro_torch.core.atoms.ComputeAtom`` (backend
``"cuda"``)."""
from __future__ import annotations

import torch

from repro_torch.device import DeviceLike, resolve
from repro_torch.kernels.compute_atom import kernel


def burn(x=None, *, iters: int, tile: int = 256,
         device: DeviceLike = None) -> torch.Tensor:
    """Burn ``iters`` iterations on ``x`` (default: the atom's operand,
    ``eye(tile) * 0.5`` on ``device``)."""
    if x is None:
        x = torch.eye(tile, dtype=torch.float32, device=resolve(device)) * 0.5
    return kernel.burn_tile(x, iters=iters)

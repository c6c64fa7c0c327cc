"""Device selection and the sample-barrier sync for the port's entry points.

Every entry point that touches a device takes ``device``.  Left unset it is
``"cuda"``, and asking for CUDA where there is none raises: the port never
falls back to the CPU on its own.  Tests pass ``device="cpu"``.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on (``"cuda"`` unless named)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the host")
    return dev


def sync(token) -> None:
    """Wait until the device work that produced ``token`` is done.

    The counterpart of ``jax.block_until_ready``: ``token`` is a tensor or
    a tuple/list of tensors.  For CUDA tensors this synchronises the current
    stream of each device they live on; CPU tensors are ready already.
    """
    tensors = token if isinstance(token, (tuple, list)) else (token,)
    seen = set()
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.is_cuda and t.device not in seen:
            seen.add(t.device)
            torch.cuda.current_stream(t.device).synchronize()

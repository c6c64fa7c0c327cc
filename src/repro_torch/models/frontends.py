"""Modality frontend stubs for the audio and vision architectures.

As in the JAX package, these entries specify the transformer backbone only;
the modality frontend supplies precomputed frame/patch embeddings.  These
helpers build those embeddings (random, from a generator) plus the M-RoPE
position streams for qwen2-vl.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve


def _embeddings(generator: torch.Generator, shape, dtype, device):
    dev = resolve(device)
    return 0.02 * torch.randn(shape, generator=generator, dtype=dtype,
                              device=dev)


def audio_frame_embeddings(generator: torch.Generator, batch: int,
                           frames: int, d_model: int, dtype=torch.float32,
                           device: DeviceLike = None):
    """Stub for the speech encoder frontend (fbank -> conformer adapter):
    [batch, frames, d_model] drawn from ``generator`` on ``device``
    (``"cuda"`` unless named)."""
    return _embeddings(generator, (batch, frames, d_model), dtype, device)


def vision_patch_embeddings(generator: torch.Generator, batch: int,
                            patches: int, d_model: int, dtype=torch.float32,
                            device: DeviceLike = None):
    """Stub for the ViT patch-merger frontend (dynamic-resolution patches):
    [batch, patches, d_model] drawn from ``generator`` on ``device``
    (``"cuda"`` unless named)."""
    return _embeddings(generator, (batch, patches, d_model), dtype, device)


def mrope_positions(batch: int, seq: int, *,
                    grid: Optional[Tuple[int, int, int]] = None,
                    device: DeviceLike = None) -> torch.Tensor:
    """M-RoPE (t, h, w) position streams, [3, B, S] int32 on ``device``
    (``"cuda"`` unless named).

    Text tokens advance all three streams together; vision tokens advance
    (t, h, w) according to their patch-grid coordinates.  ``grid=(T,H,W)``
    places a T*H*W vision block at the start of the sequence, text after.
    """
    dev = resolve(device)
    if grid is None:
        pos = np.broadcast_to(np.arange(seq)[None], (3, seq))
    else:
        T, H, W = grid
        n_vis = T * H * W
        if n_vis > seq:
            raise ValueError(f"a vision grid of {grid} ({n_vis} patches) "
                             f"does not fit {seq} positions")
        t_ids = np.repeat(np.arange(T), H * W)
        h_ids = np.tile(np.repeat(np.arange(H), W), T)
        w_ids = np.tile(np.arange(W), T * H)
        # text continues after the max vision position
        start = max(T, H, W)
        text = np.arange(seq - n_vis) + start
        pos = np.stack([np.concatenate([t_ids, text]),
                        np.concatenate([h_ids, text]),
                        np.concatenate([w_ids, text])])      # [3, S]
    out = np.ascontiguousarray(np.broadcast_to(pos[:, None], (3, batch, seq)))
    return torch.from_numpy(out.astype(np.int32)).to(dev)

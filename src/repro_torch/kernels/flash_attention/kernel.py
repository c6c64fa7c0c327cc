"""Flash attention forward on a CUDA card (FlashAttention-2, causal/window/
softcap, grouped KV heads).

``csrc/flash_attention.cu`` computes what the JAX package's Pallas
``_fa_kernel`` computes: float32 online softmax over kv tiles, the finite
``NEG_INF`` mask on absolute positions, ``hd**-0.5`` scaling then the tanh
softcap, ``p`` rounded to v's dtype before the PV product, and
``acc / max(l, 1e-30)`` in q's dtype.  Query head ``h`` reads KV head
``h // group``.  The C function picks the kernel by dtype: bfloat16 runs
on the tensor cores (``csrc/flash_attention_sm90.cu``: ``wgmma`` products,
TMA loads into a two-stage ring), float32 on the SIMT pipes in exact
float32 (``csrc/flash_attention.cu``), since the tensor cores have no
exact float32 product.  The sources say what bounds them and what their
tiles are.

``block_q`` and ``block_kv`` keep the JAX package's contract: each is
clipped to its sequence length and must divide it, or the call raises.
They are validated only; the kernel sizes its own tiles, as
``stream_pass`` does with ``block``.

``flash_attention`` launches the kernel for CUDA tensors and the plain
version (``ref.flash_attention``) for CPU tensors; any other input raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ref

#: kernel launches issued by ``flash_attention`` (one a call; CUDA only)
launches = 0

#: dtype codes of the C interface
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

MAX_HEAD_DIM = 256


def check_input(q, k, v, *, group: int, block_q: int,
                block_kv: int) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"flash_attention: {name} must be a tensor, got "
                            f"{type(t).__name__}")
        if t.dim() != 3:
            raise ValueError(f"flash_attention: {name} must be 3-D, got "
                             f"shape {tuple(t.shape)}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q, k, v "
                        f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    BH, Sq, hd = q.shape
    BKV, Sk, hdk = k.shape
    if tuple(v.shape) != (BKV, Sk, hdk) or hdk != hd:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must be [BKV, Sk, {hd}]")
    if not isinstance(group, int) or group < 1 or BH != BKV * group:
        raise ValueError(f"flash_attention: BH == BKV * group must hold, got "
                         f"BH={BH}, BKV={BKV}, group={group!r}")
    if hd % 8 or not 0 < hd <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention takes a head dim that is a "
                         f"multiple of 8 up to {MAX_HEAD_DIM}, got {hd}")
    if Sq == 0 or Sk == 0:
        raise ValueError("flash_attention takes non-empty sequences")
    bq, bkv = min(block_q, Sq), min(block_kv, Sk)
    if bq <= 0 or bkv <= 0 or Sq % bq or Sk % bkv:
        raise ValueError(f"flash_attention: the blocks must divide the "
                         f"sequences, got Sq={Sq}, block_q={block_q}, "
                         f"Sk={Sk}, block_kv={block_kv}")
    devices = {q.device, k.device, v.device}
    if len(devices) != 1 or q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs with q, k, v on one cpu or "
                         f"cuda device, got {sorted(map(str, devices))}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention takes contiguous q, k, v")
    if q.device.type == "cuda" and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention takes 16-byte aligned q, k, v")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None, block_q: int = 512,
                    block_kv: int = 512, group: int = 1) -> torch.Tensor:
    """q: [BH, Sq, hd]; k, v: [BKV, Sk, hd] with BH == BKV * group."""
    global launches
    check_input(q, k, v, group=group, block_q=block_q, block_kv=block_kv)
    if window is not None and (not isinstance(window, int) or window < 0):
        raise ValueError(f"window must be None or an int >= 0, got "
                         f"{window!r}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be None or > 0, got {softcap!r}")
    if q.device.type == "cpu":
        return ref.flash_attention(q, k, v, causal=causal, window=window,
                                   softcap=softcap, group=group)
    BH, Sq, hd = q.shape
    BKV, Sk, _ = k.shape
    lib = build.load()
    out = torch.empty_like(q)
    err = lib.synapse_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        BH, BKV, Sq, Sk, hd, DTYPES[q.dtype], int(bool(causal)),
        -1 if window is None else window,
        0.0 if softcap is None else float(softcap), hd ** -0.5,
        q.device.index, torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, err, "flash_attention")
    launches += 1
    return out

"""Synapse memory atom: streaming passes through device memory.

The paper's memory atom malloc/frees tunable buffers; on a card the
analogous resource is device-memory bandwidth.  ``csrc/memory_atom.cu``
streams the array through the SMs (read, scale by 1.0000001, write), so
bytes moved = 2 * size * passes.  ``block`` is the paper's tunable block
knob (§IV-E.3) as the JAX package defines it: it is validated
(``n % block == 0``) but does not set the kernel's geometry, which fills
the card on its own.

Two entries.  ``stream_passes`` chains out-of-place passes, each reading
the array the previous one wrote: the JAX package's ``stream``, which the
parity tests hold; on a card with a 50 MB L2 a chain over the atom's
16 MiB block reads L2, not device memory.  ``stream_ring`` is what the
memory atom runs: in-place passes over a ``Ring`` of blocks several times
the L2's size (``L2_MULTIPLE``), one launch a call, so every pass reads
and writes device memory; a pass still moves 2 x the block's bytes.

Each launches the kernel for a CUDA tensor and the plain version
(``ref.stream_pass`` repeated, ``ref.ring_pass``) for a CPU tensor; any
other input raises.
"""
from __future__ import annotations

import threading

import torch

from repro_torch.kernels import build
from repro_torch.kernels.memory_atom import ref

#: kernel launches issued by ``stream_passes`` (one a pass; CUDA only)
launches = 0
#: kernel launches issued by ``stream_ring`` (one a call; CUDA only)
ring_launches = 0
#: passes streamed by those launches
ring_passes = 0
#: guards the counters: a thread fleet on the kernel backend streams from
#: several threads at once, and ``+=`` on a global can lose a count
_count_lock = threading.Lock()

#: a ring on a card holds at least this many times its L2's bytes
L2_MULTIPLE = 4

#: dtype codes of the C interface
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def check_input(x: torch.Tensor, block: int, passes: int) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"stream_pass takes a tensor, got {type(x).__name__}")
    if x.dtype not in DTYPES:
        raise TypeError(f"stream_pass takes float32 or bfloat16, "
                        f"got {x.dtype}")
    if x.dim() != 1 or x.shape[0] == 0:
        raise ValueError(f"stream_pass takes a non-empty 1-D array, "
                         f"got shape {tuple(x.shape)}")
    if not isinstance(block, int) or block <= 0 or x.shape[0] % block:
        raise ValueError(f"n % block must be 0, got n={x.shape[0]}, "
                         f"block={block!r}")
    if not x.is_contiguous():
        raise ValueError("stream_pass takes a contiguous array")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"stream_pass runs on cpu or cuda, not {x.device}")
    if x.device.type == "cuda" and x.data_ptr() % 16:
        raise ValueError("stream_pass takes a 16-byte aligned array")
    if not isinstance(passes, int) or passes < 0:
        raise ValueError(f"passes must be an int >= 0, got {passes!r}")


def stream_passes(x: torch.Tensor, *, block: int,
                  passes: int) -> torch.Tensor:
    """``passes`` read+write passes over x [n] (n % block == 0)."""
    global launches
    check_input(x, block, passes)
    if passes == 0:
        return x.clone()
    if x.device.type == "cpu":
        y = x
        for _ in range(passes):
            y = ref.stream_pass(y, block=block)
        return y
    lib = build.load()
    out = torch.empty_like(x)
    scratch = torch.empty_like(x)
    err = lib.synapse_stream_pass(
        x.data_ptr(), out.data_ptr(), scratch.data_ptr(), x.shape[0],
        DTYPES[x.dtype], passes, x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, "stream_pass")
    with _count_lock:
        launches += passes
    return out


def stream_pass(x: torch.Tensor, *, block: int) -> torch.Tensor:
    """One read+write pass over x [n] (n % block == 0)."""
    return stream_passes(x, block=block, passes=1)


def l2_cache_bytes(device) -> int:
    """The L2 cache's bytes of a CUDA device (cudaDevAttrL2CacheSize)."""
    dev = torch.device(device)
    lib = build.load()
    got = lib.synapse_l2_cache_bytes(
        dev.index if dev.index is not None else torch.cuda.current_device())
    if got < 0:
        build.check(lib, int(-got), "cudaDevAttrL2CacheSize")
    return int(got)


def ring_slots(block_bytes: int, device) -> int:
    """Blocks a ring holds: on a card the fewest whose bytes reach
    ``L2_MULTIPLE`` x its L2, so a pass never finds its block in L2 (13 of
    16 MiB for the H100's 50 MiB); on the CPU one, where there is no device
    cache to outrun and the ring is then the chained stream.  The L2's
    size is PyTorch's reading of the card (the same attribute
    ``l2_cache_bytes`` reads through the kernel library), so the
    ``"torch"`` backend's ring needs no kernel build."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return 1
    l2 = torch.cuda.get_device_properties(dev).L2_cache_size
    return max(1, -(-L2_MULTIPLE * l2 // block_bytes))


class Ring:
    """``slots`` float32 blocks of ``block_bytes`` each, made once (filled
    with ones, the atom's operand) and streamed in place, with the pass
    counter that numbers its passes across calls.  Claiming passes is
    thread-safe; two threads that stream one ring at once leave values
    that depend on the interleaving (csrc/ring.cuh), never other amounts.
    """

    def __init__(self, block_bytes: int, device, slots: int = None):
        if not isinstance(block_bytes, int) or block_bytes < 4:
            raise ValueError(f"a ring block holds at least one float32, "
                             f"got block_bytes={block_bytes!r}")
        dev = torch.device(device)
        self.block_bytes = block_bytes
        self.slots = slots if slots is not None else ring_slots(
            block_bytes, dev)
        self.data = torch.ones((self.slots, block_bytes // 4),
                               dtype=torch.float32, device=dev)
        self.passes = 0
        self._lock = threading.Lock()

    @property
    def device(self) -> torch.device:
        return self.data.device

    def claim(self, passes: int) -> int:
        """Number the next ``passes`` passes; returns the first."""
        with self._lock:
            start = self.passes
            self.passes += passes
        return start

    def slot(self, p: int) -> torch.Tensor:
        """The block pass ``p`` streams."""
        return self.data[p % self.slots]


def check_ring(ring: Ring) -> None:
    if not isinstance(ring, Ring):
        raise TypeError(f"takes a Ring, got {type(ring).__name__}")
    data = ring.data
    if data.device.type not in ("cpu", "cuda"):
        raise ValueError(f"a ring streams on cpu or cuda, not {data.device}")
    if data.device.type == "cuda" and (data.shape[1] % 4
                                       or data.data_ptr() % 16):
        raise ValueError(f"a ring on a card takes whole 16-byte vectors: "
                         f"{data.shape[1]} float32 a block")


def stream_ring(ring: Ring, *, passes: int) -> torch.Tensor:
    """``passes`` >= 1 in-place passes over ``ring``, numbered on from its
    counter; returns the block the last pass wrote."""
    global ring_launches, ring_passes
    check_ring(ring)
    if not isinstance(passes, int) or passes < 1:
        raise ValueError(f"passes must be an int >= 1, got {passes!r}")
    start = ring.claim(passes)
    data = ring.data
    if data.device.type == "cpu":
        ref.ring_pass(data, start=start, passes=passes)
        return ring.slot(start + passes - 1)
    lib = build.load()
    err = lib.synapse_stream_ring(
        data.data_ptr(), data.shape[1], ring.slots, start, passes,
        data.device.index, torch.cuda.current_stream(data.device).cuda_stream)
    build.check(lib, err, "stream_ring")
    with _count_lock:
        ring_launches += 1
        ring_passes += passes
    return ring.slot(start + passes - 1)

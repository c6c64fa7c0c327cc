"""Plain PyTorch version of the memory-atom stream pass and its ring."""
import torch

SCALE = 1.0000001


def stream_pass(x: torch.Tensor, *, block: int = 0) -> torch.Tensor:
    del block
    return x * SCALE


def ring_pass(ring: torch.Tensor, *, start: int,
              passes: int) -> torch.Tensor:
    """``passes`` in-place passes over ``ring`` [slots, n]: pass p (from
    ``start``) scales slot ``p % slots``.  With one slot this is the chained
    ``stream_pass``, value for value."""
    slots = ring.shape[0]
    for p in range(start, start + passes):
        ring[p % slots].mul_(SCALE)
    return ring


def bytes_moved(nbytes: int, passes: int) -> float:
    return 2.0 * nbytes * passes

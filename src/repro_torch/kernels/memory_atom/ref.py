"""Plain PyTorch version of the memory-atom stream pass."""
import torch


def stream_pass(x: torch.Tensor, *, block: int = 0) -> torch.Tensor:
    del block
    return x * 1.0000001


def bytes_moved(nbytes: int, passes: int) -> float:
    return 2.0 * nbytes * passes

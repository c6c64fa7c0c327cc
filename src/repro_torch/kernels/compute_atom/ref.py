"""Plain PyTorch version of the compute-atom burn (a matmul chain)."""
import torch


def burn_tile(x: torch.Tensor, *, iters: int) -> torch.Tensor:
    y = x
    for _ in range(iters):
        y = (y @ x) * 0.5 + 0.25
    return y


def flops(tile: int, iters: int) -> float:
    return 2.0 * tile ** 3 * iters

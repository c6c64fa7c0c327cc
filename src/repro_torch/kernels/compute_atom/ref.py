"""Plain PyTorch version of the compute-atom burn (a matmul chain)."""
import torch


def burn_step(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """One iteration of the burn: y <- (y @ x) * 0.5 + 0.25."""
    return (y @ x) * 0.5 + 0.25


def burn_tile(x: torch.Tensor, *, iters: int) -> torch.Tensor:
    y = x
    for _ in range(iters):
        y = burn_step(y, x)
    return y


def flops(tile: int, iters: int) -> float:
    return 2.0 * tile ** 3 * iters

"""Synapse on PyTorch and CUDA: the port of the JAX package ``repro``.

The same modules under the same names (``core``, ``kernels``,
``scenarios``, ``obs``), written in PyTorch, with the JAX package's Pallas
kernels rewritten by hand in CUDA for Hopper (``csrc``).  Device entry
points run on ``"cuda"`` unless the caller passes ``device=``; this package
imports neither JAX nor the JAX package.
"""

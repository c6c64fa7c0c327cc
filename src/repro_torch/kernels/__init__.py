"""Hand-written CUDA kernels for the port's hot spots (Hopper, sm_90a).

Each kernel is a subpackage: ``kernel.py`` (the wrapper: checks its inputs,
launches the CUDA kernel for a CUDA tensor and counts the launch, or runs
the plain version for a CPU tensor), ``ops.py`` (the entry point the atoms
and the segment runner call) and ``ref.py`` (the plain PyTorch version).
The CUDA sources live in ``repro_torch/csrc`` (device code that two
kernels share in ``*.cuh``) and are built at first use by ``build``.
"""

from repro_torch.kernels.memory_atom import ops, ref  # noqa

from repro_torch.kernels.compute_atom import ops, ref  # noqa

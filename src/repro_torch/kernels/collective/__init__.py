from repro_torch.kernels.collective import ops, ref  # noqa

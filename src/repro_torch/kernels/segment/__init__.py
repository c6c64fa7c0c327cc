from repro_torch.kernels.segment import ops, ref  # noqa

from repro_torch.kernels.linrec.ops import linrec

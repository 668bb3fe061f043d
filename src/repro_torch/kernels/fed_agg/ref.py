"""Plain PyTorch version of the fed_agg kernel (the oracle the kernel is
held against, and the path for tensors on the CPU)."""
from __future__ import annotations

import torch


def fed_agg_2d_ref(stacked: torch.Tensor, weights: torch.Tensor
                   ) -> torch.Tensor:
    """out[n] = sum_k w[k] * x[k, n] in x's dtype.

    Accumulates in fp32 in k order, rounding each product and each sum (no
    fused multiply-add): the arithmetic of the reference's
    `core.aggregation.weighted_average`, which it matches bit for bit."""
    x = stacked.float()
    w = weights.to(x.device, torch.float32)
    acc = torch.zeros(x.shape[1:], dtype=torch.float32, device=x.device)
    for k in range(x.shape[0]):
        acc = acc + w[k] * x[k]
    return acc.to(stacked.dtype)

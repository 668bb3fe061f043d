"""Plain PyTorch version of the fed_agg kernel (the oracle the kernel is
held against, and the path for tensors on the CPU)."""
from __future__ import annotations

import numpy as np
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


def fed_agg_grouped_ref(members, weights) -> list[torch.Tensor]:
    """members[k][l]: leaf l of member k; weights K values on the host,
    rounded once to fp32 -> the merged leaves, each fed_agg_2d_ref over its
    K members (the grouped kernel's function, leaf by leaf)."""
    w = torch.from_numpy(np.asarray(weights, np.float64).astype(np.float32))
    return [fed_agg_2d_ref(torch.stack([m[l].reshape(-1) for m in members]),
                           w).view(leaf.shape)
            for l, leaf in enumerate(members[0])]

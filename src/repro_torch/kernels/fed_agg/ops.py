"""Public API of the fed_agg kernel: the CUDA kernel for CUDA tensors, the
plain version for CPU tensors (or when `impl="ref"` asks for it); a
parameter-tree wrapper that makes one aggregation one launch."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.fed_agg.kernel import fed_agg_cuda
from repro_torch.kernels.fed_agg.ref import fed_agg_2d_ref
from repro_torch.tree import leaves, unflatten_like

IMPLS = ("auto", "ref")


def fed_agg(stacked: torch.Tensor, weights: torch.Tensor, *,
            impl: str = "auto") -> torch.Tensor:
    """stacked (K, ...) -> weighted sum over axis 0 (fp32 accumulate)."""
    if impl not in IMPLS:
        raise ValueError(f"impl {impl!r}; have {IMPLS}")
    K = stacked.shape[0]
    flat = stacked.reshape(K, -1)
    if impl == "ref" or stacked.device.type == "cpu":
        out = fed_agg_2d_ref(flat, weights)
    else:
        out = fed_agg_cuda(flat.contiguous(),
                           weights.to(stacked.device, torch.float32))
    return out.reshape(stacked.shape[1:])


def fed_agg_tree(param_list, weights, *, impl: str = "auto"):
    """Aggregate a list of parameter trees into one.

    Each member's leaves of one dtype are flattened into one row of a
    (K, N) buffer, so an aggregation is one kernel launch per dtype present
    (one for the fp32 CNN), not one per leaf."""
    template = param_list[0]
    member_leaves = [leaves(p) for p in param_list]
    first = member_leaves[0]
    device = first[0].device
    w = torch.as_tensor(np.asarray(weights, np.float64),
                        dtype=torch.float32).to(device)
    out: list = [None] * len(first)
    for dtype in dict.fromkeys(l.dtype for l in first):
        idx = [i for i, l in enumerate(first) if l.dtype == dtype]
        sizes = [first[i].numel() for i in idx]
        buf = torch.empty(len(param_list), sum(sizes), dtype=dtype,
                          device=device)
        for k, ml in enumerate(member_leaves):
            torch.cat([ml[i].reshape(-1) for i in idx], out=buf[k])
        merged = fed_agg(buf, w, impl=impl)
        for i, part in zip(idx, merged.split(sizes)):
            out[i] = part.view(first[i].shape)
    return unflatten_like(template, out)

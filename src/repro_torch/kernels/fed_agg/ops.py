"""Public API of the fed_agg kernel: the CUDA kernel for CUDA tensors, the
plain version for CPU tensors (or when `impl="ref"` asks for it); a
parameter-tree wrapper that makes one aggregation one launch."""
from __future__ import annotations

import torch

from repro_torch.kernels.fed_agg.kernel import (fed_agg_cuda,
                                                fed_agg_grouped_cuda)
from repro_torch.kernels.fed_agg.ref import fed_agg_2d_ref, fed_agg_grouped_ref
from repro_torch.tree import leaves, unflatten_like

IMPLS = ("auto", "ref")


def fed_agg(stacked: torch.Tensor, weights, *,
            impl: str = "auto") -> torch.Tensor:
    """stacked (K, ...) -> weighted sum over axis 0 (fp32 accumulate);
    weights K values on the host (a sequence, numpy array or CPU
    tensor)."""
    if impl not in IMPLS:
        raise ValueError(f"impl {impl!r}; have {IMPLS}")
    K = stacked.shape[0]
    flat = stacked.reshape(K, -1)
    if impl == "ref" or stacked.device.type == "cpu":
        out = fed_agg_2d_ref(flat, torch.as_tensor(weights))
    else:
        out = fed_agg_cuda(flat.contiguous(), weights)
    return out.reshape(stacked.shape[1:])


def fed_agg_tree(param_list, weights, *, impl: str = "auto"):
    """Aggregate a list of parameter trees into one: every leaf of every
    dtype in one kernel launch on CUDA (the weights passed by value, no
    copy and no other device operation), leaf by leaf through the plain
    version on the CPU or with impl="ref"."""
    if impl not in IMPLS:
        raise ValueError(f"impl {impl!r}; have {IMPLS}")
    members = [leaves(p) for p in param_list]
    if impl == "ref" or members[0][0].device.type == "cpu":
        merged = fed_agg_grouped_ref(members, weights)
    else:
        merged = fed_agg_grouped_cuda(members, weights)
    return unflatten_like(param_list[0], merged)

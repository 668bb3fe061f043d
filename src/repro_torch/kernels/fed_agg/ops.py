"""Public API of the fed_agg kernel: the CUDA kernel for CUDA tensors, the
plain version for CPU tensors (or when `impl="ref"` asks for it), an
empty output for meta tensors; a parameter-tree wrapper that makes one
aggregation one launch.  An `impl="auto"` call reports the kernel's work
(dist/hardware.fed_agg_work) to an active cost walk (dist/cost.py)."""
from __future__ import annotations

import torch

from repro_torch.dist import cost, hardware
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
    if impl == "ref":
        return fed_agg_2d_ref(flat, torch.as_tensor(weights)).reshape(
            stacked.shape[1:])
    size = stacked.dtype.itemsize
    with cost.kernel_call("fed_agg", lambda: hardware.fed_agg_work(
            K, flat.shape[1], size, size)):
        if stacked.device.type == "meta":
            return torch.empty(stacked.shape[1:], dtype=stacked.dtype,
                               device="meta")
        if stacked.device.type == "cpu":
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
    if impl == "ref":
        return unflatten_like(param_list[0],
                              fed_agg_grouped_ref(members, weights))

    def work():
        works = [hardware.fed_agg_work(len(members), l.numel(),
                                       l.dtype.itemsize, l.dtype.itemsize)
                 for l in members[0]]
        return ({"float32": sum(w[0]["float32"] for w in works)},
                sum(w[1] for w in works))

    with cost.kernel_call("fed_agg", work):
        device = members[0][0].device.type
        if device == "meta":
            merged = [torch.empty_like(l) for l in members[0]]
        elif device == "cpu":
            merged = fed_agg_grouped_ref(members, weights)
        else:
            merged = fed_agg_grouped_cuda(members, weights)
        return unflatten_like(param_list[0], merged)

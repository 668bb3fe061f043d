"""Public flash-attention API, in the (B, T, H, D) layout the models use.

`impl="auto"` launches the CUDA kernel for CUDA tensors, on the tensors as
they lie (no transposed copies), runs the plain version (ref.py) for CPU
tensors and returns an empty output for meta tensors; `impl="ref"`
forces the plain version.  An `impl="auto"` call reports the kernel's
work (dist/hardware.flash_attention_work) to an active cost walk
(dist/cost.py), whatever the device.  Forward only, as
the reference's Pallas kernel is: the reference differentiates only its
plain attention routes, and training in the port takes those too
(`models.layers.select_attention` routes a call that carries a gradient
before it reaches this op).  A gradient request here raises; a backward
kernel is optional later work.
"""
from __future__ import annotations

import torch

from repro_torch.dist import cost, hardware
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import attention_ref

IMPLS = ("auto", "ref")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    impl: str = "auto"):
    """q: (B, T, H, D); k/v: (B, S, Hkv, D) -> (B, T, H, D)."""
    if impl not in IMPLS:
        raise ValueError(f"impl {impl!r}; have {IMPLS}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention has no backward kernel; a call that carries a "
            "gradient takes the plain attention routes "
            "(models.layers.select_attention)")
    if impl == "ref":
        return _plain(q, k, v, causal, window)
    B, T, H, D = q.shape
    with cost.kernel_call("flash_attention",
                          lambda: hardware.flash_attention_work(
                              B, T, k.shape[1], H, k.shape[2], D, window,
                              causal, q.dtype)):
        # contiguous, as the kernel writes it, on every device
        if q.device.type == "meta":
            return torch.empty(q.shape, dtype=q.dtype, device="meta")
        if q.device.type == "cpu":
            return _plain(q, k, v, causal, window).contiguous()
        return flash_attention_cuda(q, k, v, causal=causal, window=window)


def _plain(q, k, v, causal, window):
    out = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=causal, window=window)
    return out.transpose(1, 2)

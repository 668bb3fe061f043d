"""Public flash-attention API, in the (B, T, H, D) layout the models use.

`impl="auto"` launches the CUDA kernel for CUDA tensors, on the tensors as
they lie (no transposed copies), runs the plain version (ref.py) for CPU
tensors and returns an empty output for meta tensors; `impl="ref"`
forces the plain version.  An `impl="auto"` call reports the kernel's
work (dist/hardware.flash_attention_work) to an active cost walk
(dist/cost.py), whatever the device.  Forward only, as
the reference's Pallas kernel is: a gradient request here raises.

`flash_attention_train` is the differentiable op (a torch.autograd.Function)
that `models.layers.select_attention` routes a call that carries a gradient
to, on the card, when the training kernels take it (kernel.takes_grad): the
forward saves each row's log-sum-exp and the backward runs the hand-written
backward kernels.  CPU tensors run the plain pair (ref.attention_lse_ref,
ref.attention_bwd_ref), meta tensors return empty outputs; forward and
backward each report their work to an active cost walk.
"""
from __future__ import annotations

import torch

from repro_torch.dist import cost, hardware
from repro_torch.kernels.flash_attention.kernel import (
    flash_attention_cuda, flash_attention_train_bwd_cuda,
    flash_attention_train_fwd_cuda)
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_lse_ref,
                                                     attention_ref)

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


def _bhtd(*ts):
    return tuple(t.transpose(1, 2) for t in ts)


class _FlashTrain(torch.autograd.Function):
    """o = attention(q, k, v) with its backward, (B, T, H, D) layout."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        B, T, H, D = q.shape
        Hkv = k.shape[2]
        with cost.kernel_call(
                "flash_attention_train_fwd",
                lambda: hardware.flash_attention_train_fwd_work(
                    B, T, H, Hkv, D, window, causal, q.dtype)):
            if q.device.type == "meta":
                o, o_lo = (torch.empty(q.shape, dtype=q.dtype, device="meta")
                           for _ in range(2))
                lse = torch.empty(B, H, T, device="meta")
            elif q.device.type == "cpu":
                of, lse = attention_lse_ref(*_bhtd(q, k, v), causal=causal,
                                            window=window)
                of = of.transpose(1, 2).contiguous()
                o = of.to(q.dtype)                     # o + o_lo, as the
                o_lo = (of - o.float()).to(q.dtype)    # kernel writes them
            else:
                o, o_lo, lse = flash_attention_train_fwd_cuda(
                    q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, o, o_lo, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, o_lo, lse = ctx.saved_tensors
        causal, window = ctx.causal, ctx.window
        B, T, H, D = q.shape
        Hkv = k.shape[2]
        with cost.kernel_call(
                "flash_attention_train_bwd",
                lambda: hardware.flash_attention_train_bwd_work(
                    B, T, H, Hkv, D, window, causal, q.dtype)):
            if q.device.type == "meta":
                dq, dk, dv = (torch.empty(t.shape, dtype=t.dtype,
                                          device="meta") for t in (q, k, v))
            elif q.device.type == "cpu":
                dq, dk, dv = _bhtd(*attention_bwd_ref(
                    *_bhtd(q, k, v, o.float() + o_lo.float()), lse,
                    do.transpose(1, 2), causal=causal, window=window))
            else:
                dq, dk, dv = flash_attention_train_bwd_cuda(
                    q, k, v, o, o_lo, lse, do, causal=causal, window=window)
        return dq, dk, dv, None, None


def flash_attention_train(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, T, H, D); k/v: (B, T, Hkv, D) -> (B, T, H, D), differentiable
    in q, k and v.  Self attention only (S == T); CUDA tensors must be
    what the training kernels take (kernel.takes_grad)."""
    if k.shape[1] != q.shape[1] or q.shape[2] % k.shape[2]:
        raise ValueError(f"flash_attention_train: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}: needs S == T and H a multiple "
                         "of Hkv")
    if window < 0:
        raise ValueError(f"flash_attention_train: window {window} < 0")
    return _FlashTrain.apply(q, k, v, bool(causal), int(window))

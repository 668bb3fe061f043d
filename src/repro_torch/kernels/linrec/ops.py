"""Public linrec API: the diagonal recurrence h_t = a_t h_{t-1} + b_t over
axis -2, from a starting state h0 (zeros by default).

With h0 = 0 it is the reference's `linrec` (src/repro/kernels/linrec/
ops.py); with an h0 it is the models' `_chunked_linear_scan`
(src/repro/models/ssm.py), which the port's SSM and RG-LRU layers call
through it.  Leading dims are flattened into one batch axis, as the
reference's wrapper does.  `impl="auto"` launches the CUDA kernel for
CUDA tensors, runs the plain version (ref.py) for CPU tensors and returns
an empty output for meta tensors; `impl="ref"` forces the plain version.
An `impl="auto"` call reports the kernel's work
(dist/hardware.linrec_work) to an active cost walk (dist/cost.py).  Forward only, as the reference's
Pallas kernel is: the reference differentiates only its chunked
associative scan, and training in the port takes that scan too
(`models.ssm._chunked_linear_scan`, chosen by `models.ssm._scan` before a
call that carries a gradient reaches this op).  A gradient request here
raises; a backward kernel is optional later work.
"""
from __future__ import annotations

import math

import torch

from repro_torch.dist import cost, hardware
from repro_torch.kernels.linrec.kernel import linrec_cuda
from repro_torch.kernels.linrec.ref import linrec_ref

IMPLS = ("auto", "ref")


def linrec(a, b, h0=None, *, impl: str = "auto"):
    """a, b: (..., T, D); h0: (..., D) or None -> hs (..., T, D) fp32."""
    if impl not in IMPLS:
        raise ValueError(f"impl {impl!r}; have {IMPLS}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (a, b, h0)):
        raise NotImplementedError(
            "linrec has no backward kernel; a call that carries a "
            "gradient takes the chunked scan "
            "(models.ssm._chunked_linear_scan)")
    shape = a.shape
    T, D = shape[-2], shape[-1]
    B = math.prod(shape[:-2])
    a3, b3 = a.reshape(B, T, D), b.reshape(B, T, D)
    h03 = None if h0 is None else h0.reshape(B, D)
    if impl == "ref":
        return linrec_ref(a3, b3, h03).reshape(shape)
    with cost.kernel_call("linrec", lambda: hardware.linrec_work(
            B, T, D, a.element_size(), h0 is not None)):
        if a.device.type == "meta":
            return torch.empty(shape, dtype=torch.float32, device="meta")
        if a.device.type == "cpu":
            hs = linrec_ref(a3, b3, h03)
        else:
            hs = linrec_cuda(a3, b3, h03)
        return hs.reshape(shape)

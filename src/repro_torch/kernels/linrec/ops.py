"""Public linrec API: the diagonal recurrence h_t = a_t h_{t-1} + b_t over
axis -2, from a starting state h0 (zeros by default).

With h0 = 0 it is the reference's `linrec` (src/repro/kernels/linrec/
ops.py); with an h0 it is the models' `_chunked_linear_scan`
(src/repro/models/ssm.py), which the port's SSM and RG-LRU layers call
through it.  Leading dims are flattened into one batch axis, as the
reference's wrapper does.  `impl="auto"` launches the CUDA kernel for
CUDA tensors and runs the plain version (ref.py) for CPU tensors;
`impl="ref"` forces the plain version.  Forward only, as the reference's
Pallas kernel is: the reference differentiates only its chunked
associative scan, and training in the port takes that scan too
(`models.ssm._chunked_linear_scan`, chosen by `models.ssm._scan` before a
call that carries a gradient reaches this op).  A gradient request here
raises; a backward kernel is optional later work.
"""
from __future__ import annotations

import math

import torch

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
    if impl == "ref" or a.device.type == "cpu":
        hs = linrec_ref(a3, b3, h03)
    else:
        hs = linrec_cuda(a3, b3, h03)
    return hs.reshape(shape)

"""Public API of the quant8 kernels, the two scale layouts of
core.compression:

* `quantize` / `dequantize` -- BLOCKWISE wire format ((nblocks, block)
  int8 + one scale per block); the zero pad up to a block multiple crosses
  the wire, as in the reference.
* `quantize_rowwise` / `dequantize_rowwise` -- one scale per last-dim
  channel; q keeps the input's shape (the exchange's layout).  There is no
  lane pad: zero padding never changes a row's absmax, so the kernel takes
  any C.

`impl="auto"` launches the CUDA kernels for CUDA tensors and runs the plain
version (ref.py) for CPU tensors; `impl="ref"` forces the plain version.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.quant8.kernel import (dequantize_rows_cuda,
                                               quantize_rows_cuda)
from repro_torch.kernels.quant8.ref import (dequantize_rows_ref,
                                            quantize_rows_ref)

BLOCK = 256
IMPLS = ("auto", "ref")


def _plain(t: torch.Tensor, impl: str) -> bool:
    if impl not in IMPLS:
        raise ValueError(f"impl {impl!r}; have {IMPLS}")
    return impl == "ref" or t.device.type == "cpu"


def quantize_rows(x2: torch.Tensor, *, impl: str = "auto"):
    """x2 (R, C) float -> (q int8 (R, C), fp32 scales (R, 1))."""
    if _plain(x2, impl):
        return quantize_rows_ref(x2)
    if x2.dtype not in (torch.float32, torch.bfloat16):
        x2 = x2.float()
    return quantize_rows_cuda(x2.contiguous())


def dequantize_rows(q2: torch.Tensor, scale2: torch.Tensor, *,
                    out_dtype=torch.float32, impl: str = "auto"):
    """q2 (R, C) int8, scale2 (R, 1) fp32 -> (R, C) in out_dtype."""
    if _plain(q2, impl):
        return dequantize_rows_ref(q2, scale2, out_dtype)
    return dequantize_rows_cuda(q2.contiguous(), scale2.contiguous(),
                                out_dtype)


def quantize(x: torch.Tensor, *, block: int = BLOCK, impl: str = "auto"):
    """x any shape -> (q int8 (nblocks, block), fp32 scales (nblocks,))."""
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % block
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    q, s = quantize_rows(flat.reshape(-1, block), impl=impl)
    return q, s[:, 0]


def dequantize(q: torch.Tensor, scales: torch.Tensor, shape, *,
               out_dtype=torch.float32, impl: str = "auto"):
    """Inverse of `quantize`: the first prod(shape) values, reshaped."""
    flat = dequantize_rows(q, scales.reshape(-1, 1), out_dtype=out_dtype,
                           impl=impl).reshape(-1)
    return flat[:math.prod(shape)].reshape(shape)


def quantize_rowwise(x: torch.Tensor, *, impl: str = "auto"):
    """x (..., C) -> (q int8 SAME shape, fp32 scales (..., 1)); the leading
    dims collapse to kernel rows."""
    C = x.shape[-1]
    q, s = quantize_rows(x.reshape(-1, C), impl=impl)
    return q.reshape(x.shape), s.reshape(x.shape[:-1] + (1,))


def dequantize_rowwise(q: torch.Tensor, scale: torch.Tensor, *,
                       out_dtype=torch.float32, impl: str = "auto"):
    """Inverse of quantize_rowwise: q (..., C) int8, scale (..., 1)."""
    C = q.shape[-1]
    out = dequantize_rows(q.reshape(-1, C), scale.reshape(-1, 1),
                          out_dtype=out_dtype, impl=impl)
    return out.reshape(q.shape)

"""Plain PyTorch versions of the quant8 kernels (the oracle the kernels are
held against, and the path for tensors on the CPU).

This is the reference's `core.compression._symmetric_q8` sequence, op for
op, so q and scales equal the JAX package's bit for bit.  Two steps are
written out that JAX leaves implicit:

* both divisions divide by a tensor: PyTorch's CUDA division by a Python
  scalar multiplies by its reciprocal, which is not the IEEE quotient and
  puts a scale one ulp off the reference's (and the kernel's);
* XLA converts a NaN to the integer 0, while a NaN cast to int8 is
  undefined in C++, so the NaN quotients of a row that holds NaN or inf
  are zeroed before the cast.
"""
from __future__ import annotations

import torch


def quantize_rows_ref(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x (R, C) float -> (q int8 (R, C), fp32 scales (R, 1)), per row:
    scale = amax / 127, q = clip(round(x / max(scale, 1e-12)), -127, 127).
    NaN or inf in a row propagate to its scale, and its q are 0 where the
    quotient is NaN, as in the reference."""
    x = x.float()
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = amax / torch.full_like(amax, 127.0)      # IEEE, on every device
    safe = scale.clamp(min=1e-12)      # zero rows -> q = 0; NaN stays NaN
    r = torch.round(x / safe).clamp(-127.0, 127.0)
    return torch.nan_to_num(r, nan=0.0).to(torch.int8), scale


def dequantize_rows_ref(q: torch.Tensor, scale: torch.Tensor,
                        out_dtype=torch.float32) -> torch.Tensor:
    """q (R, C) int8, scale (R, 1) fp32 -> q * scale in out_dtype."""
    return (q.float() * scale).to(out_dtype)


def quantize_rows_grouped_ref(xs) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """The grouped kernel's plain version: quantize_rows_ref leaf by leaf."""
    return [quantize_rows_ref(x) for x in xs]


def dequantize_rows_grouped_ref(qs, ss, out_dtype=torch.float32
                                ) -> list[torch.Tensor]:
    """The grouped kernel's plain version: dequantize_rows_ref leaf by
    leaf."""
    return [dequantize_rows_ref(q, s, out_dtype)
            for q, s in zip(qs, ss, strict=True)]

"""Public API of the quant8 kernels, the two scale layouts of
core.compression:

* `quantize` / `dequantize` -- BLOCKWISE wire format ((nblocks, block)
  int8 + one scale per block); the zero pad up to a block multiple crosses
  the wire, as in the reference.
* `quantize_rowwise` / `dequantize_rowwise` -- one scale per last-dim
  channel; q keeps the input's shape (the exchange's layout).  There is no
  lane pad: zero padding never changes a row's absmax, so the kernel takes
  any C.

Each has a grouped form over a list of leaves (`quantize_grouped`,
`quantize_rowwise_grouped`, `quantize_rows_grouped` and their inverses):
one kernel launch for the whole list (one per input dtype), so an exchange
or a K/V pair pays one launch, not one per leaf.  The single-tensor functions are a group of one.

`impl="auto"` launches the CUDA kernels for CUDA tensors, runs the plain
version (ref.py) for CPU tensors and returns empty outputs for meta
tensors; `impl="ref"` forces the plain version.  An `impl="auto"` grouped
call reports the kernel's work (dist/hardware.quant8_quantize_work /
quant8_dequantize_work over its leaves) to an active cost walk
(dist/cost.py), whatever the device.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

from repro_torch.dist import cost, hardware
from repro_torch.kernels.quant8.kernel import (dequantize_grouped_cuda,
                                               quantize_grouped_cuda)
from repro_torch.kernels.quant8.ref import (dequantize_rows_grouped_ref,
                                            quantize_rows_grouped_ref)

BLOCK = 256
IMPLS = ("auto", "ref")


def _check(impl: str) -> str:
    if impl not in IMPLS:
        raise ValueError(f"impl {impl!r}; have {IMPLS}")
    return impl


def _plain(ts: Sequence[torch.Tensor], impl: str) -> bool:
    """The plain version for impl="ref" or when every tensor lies on the
    CPU; a list holding a CUDA tensor goes to the kernel (which raises on
    a mixed list)."""
    return _check(impl) == "ref" or all(t.device.type == "cpu" for t in ts)


def quantize_rows_grouped(xs: Sequence[torch.Tensor], *, impl: str = "auto"):
    """Leaves x_i (R_i, C_i) float -> [(q_i int8 (R_i, C_i), fp32 scales
    (R_i, 1))]; one launch per input dtype (fp32, bf16; others go as
    fp32)."""
    xs = list(xs)
    if _check(impl) == "ref":
        return quantize_rows_grouped_ref(xs)
    with cost.kernel_call("quant8_quantize", lambda: _sum_work(
            hardware.quant8_quantize_work(
                x.numel(), x.shape[0], x.dtype.itemsize
                if x.dtype in (torch.float32, torch.bfloat16) else 4)
            for x in xs)):
        return _quantize_rows_grouped(xs, impl)


def _sum_work(works):
    flops, nbytes = {}, 0
    for f, b in works:
        for dt, v in f.items():
            flops[dt] = flops.get(dt, 0) + v
        nbytes += b
    return flops, nbytes


def _meta(ts) -> bool:
    return any(t.device.type == "meta" for t in ts)


def _quantize_rows_grouped(xs, impl):
    if _meta(xs):
        return [(torch.empty(x.shape, dtype=torch.int8, device="meta"),
                 torch.empty((x.shape[0], 1), dtype=torch.float32,
                             device="meta")) for x in xs]
    if _plain(xs, impl):
        return quantize_rows_grouped_ref(xs)
    xs = [(x if x.dtype in (torch.float32, torch.bfloat16) else x.float())
          .contiguous() for x in xs]
    out = [None] * len(xs)
    by_dtype: dict[torch.dtype, list[int]] = {}
    for i, x in enumerate(xs):
        by_dtype.setdefault(x.dtype, []).append(i)
    for idx in by_dtype.values():
        for i, r in zip(idx, quantize_grouped_cuda([xs[i] for i in idx])):
            out[i] = r
    return out


def dequantize_rows_grouped(qs: Sequence[torch.Tensor],
                            ss: Sequence[torch.Tensor], *,
                            out_dtype=torch.float32, impl: str = "auto"):
    """Leaves q_i (R_i, C_i) int8, s_i (R_i, 1) fp32 -> [(R_i, C_i) in
    out_dtype], one launch."""
    qs, ss = list(qs), list(ss)
    if _check(impl) == "ref":
        return dequantize_rows_grouped_ref(qs, ss, out_dtype)
    with cost.kernel_call("quant8_dequantize", lambda: _sum_work(
            hardware.quant8_dequantize_work(q.numel(), q.shape[0],
                                            out_dtype.itemsize)
            for q in qs)):
        if _meta(qs + ss):
            return [torch.empty(q.shape, dtype=out_dtype, device="meta")
                    for q in qs]
        if _plain(qs + ss, impl):
            return dequantize_rows_grouped_ref(qs, ss, out_dtype)
        return dequantize_grouped_cuda([q.contiguous() for q in qs],
                                       [s.contiguous() for s in ss],
                                       out_dtype)


def quantize_rows(x2: torch.Tensor, *, impl: str = "auto"):
    """x2 (R, C) float -> (q int8 (R, C), fp32 scales (R, 1))."""
    return quantize_rows_grouped([x2], impl=impl)[0]


def dequantize_rows(q2: torch.Tensor, scale2: torch.Tensor, *,
                    out_dtype=torch.float32, impl: str = "auto"):
    """q2 (R, C) int8, scale2 (R, 1) fp32 -> (R, C) in out_dtype."""
    return dequantize_rows_grouped([q2], [scale2], out_dtype=out_dtype,
                                   impl=impl)[0]


def quantize_grouped(xs: Sequence[torch.Tensor], *, block: int = BLOCK,
                     impl: str = "auto"):
    """Leaves of any shape -> [(q int8 (nblocks_i, block), fp32 scales
    (nblocks_i,))]: each flattened and zero-padded to a block multiple; one
    launch for the list."""
    def blocks(x):
        flat = x.reshape(-1)
        pad = (-flat.shape[0]) % block
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        return flat.reshape(-1, block)
    return [(q, s[:, 0]) for q, s in
            quantize_rows_grouped([blocks(x) for x in xs], impl=impl)]


def dequantize_grouped(qs: Sequence[torch.Tensor],
                       scales: Sequence[torch.Tensor], shapes, *,
                       out_dtype=torch.float32, impl: str = "auto"):
    """Inverse of `quantize_grouped`: per leaf the first prod(shape)
    values, reshaped; one launch."""
    outs = dequantize_rows_grouped(qs, [s.reshape(-1, 1) for s in scales],
                                   out_dtype=out_dtype, impl=impl)
    return [o.reshape(-1)[:math.prod(shape)].reshape(shape)
            for o, shape in zip(outs, shapes)]


def quantize(x: torch.Tensor, *, block: int = BLOCK, impl: str = "auto"):
    """x any shape -> (q int8 (nblocks, block), fp32 scales (nblocks,))."""
    return quantize_grouped([x], block=block, impl=impl)[0]


def dequantize(q: torch.Tensor, scales: torch.Tensor, shape, *,
               out_dtype=torch.float32, impl: str = "auto"):
    """Inverse of `quantize`: the first prod(shape) values, reshaped."""
    return dequantize_grouped([q], [scales], [shape], out_dtype=out_dtype,
                              impl=impl)[0]


def quantize_rowwise_grouped(xs: Sequence[torch.Tensor], *,
                             impl: str = "auto"):
    """Leaves x_i (..., C_i) -> [(q_i int8 SAME shape, fp32 scales
    (..., 1))]; each leaf's leading dims collapse to kernel rows, and the
    whole list is one launch."""
    xs = list(xs)
    pairs = quantize_rows_grouped([x.reshape(-1, x.shape[-1]) for x in xs],
                                  impl=impl)
    return [(q.reshape(x.shape), s.reshape(x.shape[:-1] + (1,)))
            for x, (q, s) in zip(xs, pairs)]


def dequantize_rowwise_grouped(qs: Sequence[torch.Tensor],
                               ss: Sequence[torch.Tensor], *,
                               out_dtype=torch.float32, impl: str = "auto"):
    """Inverse of quantize_rowwise_grouped: q_i (..., C_i) int8, s_i
    (..., 1); one launch."""
    qs = list(qs)
    outs = dequantize_rows_grouped(
        [q.reshape(-1, q.shape[-1]) for q in qs],
        [s.reshape(-1, 1) for s in ss], out_dtype=out_dtype, impl=impl)
    return [o.reshape(q.shape) for q, o in zip(qs, outs)]


def quantize_rowwise(x: torch.Tensor, *, impl: str = "auto"):
    """x (..., C) -> (q int8 SAME shape, fp32 scales (..., 1)); the leading
    dims collapse to kernel rows."""
    return quantize_rowwise_grouped([x], impl=impl)[0]


def dequantize_rowwise(q: torch.Tensor, scale: torch.Tensor, *,
                       out_dtype=torch.float32, impl: str = "auto"):
    """Inverse of quantize_rowwise: q (..., C) int8, scale (..., 1)."""
    return dequantize_rowwise_grouped([q], [scale], out_dtype=out_dtype,
                                      impl=impl)[0]

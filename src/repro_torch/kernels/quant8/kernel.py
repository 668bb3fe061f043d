"""ctypes binding of the CUDA quant8 kernels (csrc/quant8.cu).

`quantize_grouped_cuda(xs)` and `dequantize_grouped_cuda(qs, ss,
out_dtype)` take a list of leaves and launch one kernel per
`capacity()` leaves (one launch for every list the port hands them) on
PyTorch's current stream, counting their launches in `.launches`, so a run
can show that its exchanges went through the kernels.
`quantize_rows_cuda` / `dequantize_rows_cuda` are a group of one.  The
library is built from the sources at first call (kernels/build.py), never
at import.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from repro_torch.kernels.build import load_library

SOURCES = [Path(__file__).resolve().parent / "csrc" / "quant8.cu"]
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_COLS = 1 << 30             # quantise: a row's columns are 32-bit indices
_LIB: list[ctypes.CDLL] = []   # loaded once per process


def library() -> ctypes.CDLL:
    if not _LIB:
        lib = load_library("quant8", SOURCES)
        for fn in (lib.quant8_quantize_grouped, lib.quant8_dequantize_grouped):
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                           ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.quant8_group_capacity.argtypes = []
        lib.quant8_group_capacity.restype = ctypes.c_int
        lib.quant8_error_string.argtypes = [ctypes.c_int]
        lib.quant8_error_string.restype = ctypes.c_char_p
        _LIB.append(lib)
    return _LIB[0]


@functools.cache
def capacity() -> int:
    """Leaves one launch takes (the kernels' table)."""
    return library().quant8_group_capacity()


def _launch(name: str, leaves: list[tuple], dtype, device) -> int:
    """quant8_<name>_grouped over `leaves` ((src, dst, scale, rows, C),
    rows >= 1: quant8.cu's Quant8Leaf as five int64), capacity() at a
    time, on the current stream; raise on a launch error.  -> the number
    of launches."""
    lib, cap = library(), capacity()
    fn = getattr(lib, f"quant8_{name}_grouped")
    table = np.array(leaves, dtype=np.int64)
    if torch.cuda.current_device() != device.index:
        with torch.cuda.device(device):
            return _launch(name, leaves, dtype, device)
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    launches = 0
    for i in range(0, len(table), cap):
        part = table[i:i + cap]
        err = fn(part.ctypes.data, len(part), _DTYPE_CODE[dtype], stream)
        if err != 0:
            raise RuntimeError(f"quant8 {name} launch failed: CUDA error "
                               f"{err} ({lib.quant8_error_string(err).decode()})")
        launches += 1
    return launches


def _one_device(where: str, tensors) -> torch.device:
    device = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != device:
            raise ValueError(f"{where}: leaves on {t.device} and {device}; "
                             "all must be on one CUDA device")
    return device


def _offsets(sizes, align: int) -> tuple[list[int], int]:
    """Start of each of `sizes` elements in one buffer, each rounded up to
    `align` elements (so 16-byte loads and stores stay aligned); -> (starts,
    total)."""
    starts, total = [], 0
    for n in sizes:
        starts.append(total)
        total += -(-n // align) * align
    return starts, total


def quantize_grouped_cuda(xs: Sequence[torch.Tensor]
                          ) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """Leaves x_i (R_i, C_i), contiguous, all fp32 or all bf16, on one CUDA
    device -> [(q_i int8 (R_i, C_i), fp32 scales (R_i, 1))], one launch
    per capacity() leaves.  The q_i are views of one int8 buffer, the
    scales of one fp32 buffer (one allocation each, not one a leaf)."""
    xs = list(xs)
    if not xs:
        return []
    device = _one_device("quantize_grouped_cuda", xs)
    dtype = xs[0].dtype
    shapes = [x.shape for x in xs]
    for i, (x, shape) in enumerate(zip(xs, shapes)):
        if x.dtype not in _DTYPE_CODE or x.dtype != dtype:
            raise TypeError(f"quantize_grouped_cuda: leaf {i} dtype "
                            f"{x.dtype}, leaf 0 {dtype} (one of fp32, bf16)")
        if len(shape) != 2 or not 1 <= shape[1] < MAX_COLS:
            raise ValueError(f"quantize_grouped_cuda: leaf {i} "
                             f"{tuple(shape)}; need (R, C), 1 <= C < 2^30")
        if not x.is_contiguous():
            raise ValueError(f"quantize_grouped_cuda: leaf {i} must be "
                             "contiguous")
    q_at, q_total = _offsets([R * C for R, C in shapes], 16)
    s_at, s_total = _offsets([R for R, _ in shapes], 1)
    q_all = torch.empty(q_total, dtype=torch.int8, device=device)
    s_all = torch.empty(s_total, dtype=torch.float32, device=device)
    q_base, s_base = q_all.data_ptr(), s_all.data_ptr()
    out, todo = [], []
    for x, (R, C), qo, so in zip(xs, shapes, q_at, s_at):
        q = q_all.as_strided((R, C), (C, 1), qo)
        scale = s_all.as_strided((R, 1), (1, 1), so)
        out.append((q, scale))
        if R:
            todo.append((x.data_ptr(), q_base + qo, s_base + 4 * so, R, C))
    if todo:
        quantize_grouped_cuda.launches += _launch("quantize", todo, dtype,
                                                  device)
    return out


def dequantize_grouped_cuda(qs: Sequence[torch.Tensor],
                            ss: Sequence[torch.Tensor],
                            out_dtype=torch.float32) -> list[torch.Tensor]:
    """Leaves q_i (R_i, C_i) int8 with scales s_i (R_i, 1) fp32, all
    contiguous on one CUDA device -> [q_i * s_i (R_i, C_i) in out_dtype
    (fp32 or bf16)], views of one buffer; one launch per capacity()
    leaves."""
    qs, ss = list(qs), list(ss)
    if len(qs) != len(ss):
        raise ValueError(f"dequantize_grouped_cuda: {len(qs)} q, {len(ss)} "
                         "scales")
    if not qs:
        return []
    if out_dtype not in _DTYPE_CODE:
        raise TypeError(f"dequantize_grouped_cuda: out_dtype {out_dtype} "
                        "(fp32 or bf16)")
    device = _one_device("dequantize_grouped_cuda", qs + ss)
    shapes = [q.shape for q in qs]
    for i, (q, s, shape) in enumerate(zip(qs, ss, shapes)):
        if q.dtype != torch.int8 or s.dtype != torch.float32:
            raise TypeError(f"dequantize_grouped_cuda: leaf {i} q {q.dtype} "
                            f"(int8), scale {s.dtype} (fp32)")
        if len(shape) != 2 or shape[1] == 0 or s.shape != (shape[0], 1):
            raise ValueError(f"dequantize_grouped_cuda: leaf {i} q "
                             f"{tuple(shape)}, scale {tuple(s.shape)}; "
                             "need (R, C), C >= 1 and (R, 1)")
        if not (q.is_contiguous() and s.is_contiguous()):
            raise ValueError(f"dequantize_grouped_cuda: leaf {i}: q and "
                             "scale must be contiguous")
    at, total = _offsets([R * C for R, C in shapes], 16)
    o_all = torch.empty(total, dtype=out_dtype, device=device)
    base, size = o_all.data_ptr(), o_all.element_size()
    out, todo = [], []
    for q, s, (R, C), o_at in zip(qs, ss, shapes, at):
        out.append(o_all.as_strided((R, C), (C, 1), o_at))
        if R:
            todo.append((q.data_ptr(), base + size * o_at, s.data_ptr(), R,
                         C))
    if todo:
        dequantize_grouped_cuda.launches += _launch("dequantize", todo,
                                                    out_dtype, device)
    return out


def quantize_rows_cuda(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x (R, C) contiguous fp32/bf16 CUDA tensor -> (q int8 (R, C), fp32
    scales (R, 1)): a group of one."""
    return quantize_grouped_cuda([x])[0]


def dequantize_rows_cuda(q: torch.Tensor, scale: torch.Tensor,
                         out_dtype=torch.float32) -> torch.Tensor:
    """q (R, C) contiguous int8, scale (R, 1) fp32, both on one CUDA device
    -> q * scale (R, C) in out_dtype (fp32 or bf16): a group of one."""
    return dequantize_grouped_cuda([q], [scale], out_dtype)[0]


quantize_grouped_cuda.launches = 0
dequantize_grouped_cuda.launches = 0

"""ctypes binding of the CUDA quant8 kernels (csrc/quant8.cu).

`quantize_rows_cuda(x)` and `dequantize_rows_cuda(q, scale, out_dtype)`
launch on PyTorch's current stream and count their launches in
`.launches`, so a run can show that its exchanges went through the
kernels.  The library is built from the sources at first call
(kernels/build.py), never at import.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import load_library

SOURCES = [Path(__file__).resolve().parent / "csrc" / "quant8.cu"]
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_LIB: list[ctypes.CDLL] = []   # loaded once per process


def library() -> ctypes.CDLL:
    if not _LIB:
        lib = load_library("quant8", SOURCES)
        args = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
        for fn in (lib.quant8_quantize, lib.quant8_dequantize):
            fn.argtypes = args
            fn.restype = ctypes.c_int
        lib.quant8_error_string.argtypes = [ctypes.c_int]
        lib.quant8_error_string.restype = ctypes.c_char_p
        _LIB.append(lib)
    return _LIB[0]


def _launch(name: str, *ptrs, rows: int, C: int, dtype, device):
    """Call quant8_<name> on the current stream; raise on a launch error."""
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, f"quant8_{name}")(*ptrs, rows, C,
                                              _DTYPE_CODE[dtype], stream)
    if err != 0:
        raise RuntimeError(f"quant8 {name} launch failed: CUDA error {err} "
                           f"({lib.quant8_error_string(err).decode()})")


def quantize_rows_cuda(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x (R, C) contiguous fp32/bf16 CUDA tensor -> (q int8 (R, C), fp32
    scales (R, 1))."""
    if x.device.type != "cuda":
        raise ValueError(f"quantize_rows_cuda: x on {x.device}, need CUDA")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"quantize_rows_cuda: x dtype {x.dtype} (fp32 or bf16)")
    if x.dim() != 2 or x.shape[1] == 0:
        raise ValueError(f"quantize_rows_cuda: x {tuple(x.shape)}; need "
                         "(R, C), C >= 1")
    if not x.is_contiguous():
        raise ValueError("quantize_rows_cuda: x must be contiguous")
    R, C = x.shape
    q = torch.empty(R, C, dtype=torch.int8, device=x.device)
    scale = torch.empty(R, 1, dtype=torch.float32, device=x.device)
    if R == 0:
        return q, scale
    _launch("quantize", x.data_ptr(), q.data_ptr(), scale.data_ptr(),
            rows=R, C=C, dtype=x.dtype, device=x.device)
    quantize_rows_cuda.launches += 1
    return q, scale


def dequantize_rows_cuda(q: torch.Tensor, scale: torch.Tensor,
                         out_dtype=torch.float32) -> torch.Tensor:
    """q (R, C) contiguous int8, scale (R, 1) fp32, both on one CUDA device
    -> q * scale (R, C) in out_dtype (fp32 or bf16)."""
    if q.device.type != "cuda" or scale.device != q.device:
        raise ValueError(f"dequantize_rows_cuda: q on {q.device}, scale on "
                         f"{scale.device}; both must be on one CUDA device")
    if q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"dequantize_rows_cuda: q {q.dtype} (int8), scale "
                        f"{scale.dtype} (fp32)")
    if out_dtype not in _DTYPE_CODE:
        raise TypeError(f"dequantize_rows_cuda: out_dtype {out_dtype} "
                        "(fp32 or bf16)")
    if q.dim() != 2 or q.shape[1] == 0 or scale.shape != (q.shape[0], 1):
        raise ValueError(f"dequantize_rows_cuda: q {tuple(q.shape)}, scale "
                         f"{tuple(scale.shape)}; need (R, C), C >= 1 and "
                         "(R, 1)")
    if not (q.is_contiguous() and scale.is_contiguous()):
        raise ValueError("dequantize_rows_cuda: q and scale must be "
                         "contiguous")
    R, C = q.shape
    out = torch.empty(R, C, dtype=out_dtype, device=q.device)
    if R == 0:
        return out
    _launch("dequantize", q.data_ptr(), scale.data_ptr(), out.data_ptr(),
            rows=R, C=C, dtype=out_dtype, device=q.device)
    dequantize_rows_cuda.launches += 1
    return out


quantize_rows_cuda.launches = 0
dequantize_rows_cuda.launches = 0

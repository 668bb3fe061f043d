"""ctypes binding of the CUDA fed_agg kernel (csrc/fed_agg.cu).

`fed_agg_cuda(x, w)` launches on PyTorch's current stream and counts its
launches in `fed_agg_cuda.launches`, so a run can show that its merges
went through the kernel.  The library is built from the sources at first
call (kernels/build.py), never at import.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import load_library

SOURCES = [Path(__file__).resolve().parent / "csrc" / "fed_agg.cu"]
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_LIB: list[ctypes.CDLL] = []   # loaded once per process


def library() -> ctypes.CDLL:
    if not _LIB:
        lib = load_library("fed_agg", SOURCES)
        lib.fed_agg_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.fed_agg_launch.restype = ctypes.c_int
        lib.fed_agg_error_string.argtypes = [ctypes.c_int]
        lib.fed_agg_error_string.restype = ctypes.c_char_p
        _LIB.append(lib)
    return _LIB[0]


def fed_agg_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (K, N) contiguous fp32/bf16 CUDA tensor, w (K,) fp32 on the same
    device -> (N,) in x's dtype."""
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"fed_agg_cuda: x on {x.device}, w on {w.device}; "
                         "both must be on one CUDA device")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"fed_agg_cuda: x dtype {x.dtype} (fp32 or bf16)")
    if w.dtype != torch.float32:
        raise TypeError(f"fed_agg_cuda: w dtype {w.dtype} (fp32)")
    if x.dim() != 2 or w.shape != (x.shape[0],) or x.shape[0] == 0:
        raise ValueError(f"fed_agg_cuda: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}; need x (K, N), w (K,), K >= 1")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("fed_agg_cuda: x and w must be contiguous")
    K, N = x.shape
    out = torch.empty(N, dtype=x.dtype, device=x.device)
    if N == 0:
        return out
    vec = 16 // x.element_size()
    vec_ok = int(N % vec == 0 and x.data_ptr() % 16 == 0)
    lib = library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.fed_agg_launch(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                                 K, N, _DTYPE_CODE[x.dtype], vec_ok, stream)
    if err != 0:
        raise RuntimeError(f"fed_agg launch failed: CUDA error {err} "
                           f"({lib.fed_agg_error_string(err).decode()})")
    fed_agg_cuda.launches += 1
    return out


fed_agg_cuda.launches = 0

"""ctypes binding of the CUDA linrec kernel (csrc/linrec.cu).

`linrec_cuda(a, b, h0)` launches on PyTorch's current stream and counts
its launches in `linrec_cuda.launches`, so a run can show that its scans
went through the kernel.  The library is built from the sources at first
call (kernels/build.py), never at import.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import load_library

SOURCES = [Path(__file__).resolve().parent / "csrc" / "linrec.cu"]
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_LIB: list[ctypes.CDLL] = []   # loaded once per process


def library() -> ctypes.CDLL:
    if not _LIB:
        lib = load_library("linrec", SOURCES)
        lib.linrec_launch.argtypes = ([ctypes.c_void_p] * 4
                                      + [ctypes.c_int64] * 7
                                      + [ctypes.c_int, ctypes.c_void_p])
        lib.linrec_launch.restype = ctypes.c_int
        lib.linrec_error_string.argtypes = [ctypes.c_int]
        lib.linrec_error_string.restype = ctypes.c_char_p
        _LIB.append(lib)
    return _LIB[0]


def linrec_cuda(a: torch.Tensor, b: torch.Tensor,
                h0: torch.Tensor | None = None) -> torch.Tensor:
    """a, b (B, T, D) CUDA tensors of one dtype (fp32 or bf16), as they lie
    (only D need be contiguous); h0 (B, D) fp32 or None -> hs (B, T, D)
    fp32, contiguous."""
    if a.device.type != "cuda" or b.device != a.device or \
            (h0 is not None and h0.device != a.device):
        raise ValueError(f"linrec_cuda: a on {a.device}, b on {b.device}, h0 "
                         f"on {None if h0 is None else h0.device}; all on one "
                         "CUDA device")
    if a.dtype not in _DTYPE_CODE or b.dtype != a.dtype:
        raise TypeError(f"linrec_cuda: dtypes {a.dtype}, {b.dtype}; need one "
                        "of fp32, bf16 for both")
    if a.dim() != 3 or b.shape != a.shape:
        raise ValueError(f"linrec_cuda: a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}; need two equal (B, T, D)")
    B, T, D = a.shape
    for name, t in (("a", a), ("b", b)):
        if D > 1 and t.stride(2) != 1:
            raise ValueError(f"linrec_cuda: {name}'s last dim must be "
                             f"contiguous (strides {t.stride()})")
    if h0 is not None:
        if h0.dtype != torch.float32 or h0.shape != (B, D):
            raise ValueError(f"linrec_cuda: h0 {h0.dtype} "
                             f"{tuple(h0.shape)}; need fp32 (B, D) = "
                             f"{(B, D)}")
        h0 = h0.contiguous()
    if (B * D + 255) // 256 >= 2 ** 31:
        raise ValueError(f"linrec_cuda: B * D = {B * D} beyond the grid")
    out = torch.empty(B, T, D, dtype=torch.float32, device=a.device)
    if B == 0 or T == 0 or D == 0:
        return out
    lib = library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.linrec_launch(
            a.data_ptr(), b.data_ptr(),
            None if h0 is None else h0.data_ptr(), out.data_ptr(),
            B, T, D, a.stride(0), a.stride(1), b.stride(0), b.stride(1),
            _DTYPE_CODE[a.dtype], stream)
    if err != 0:
        raise RuntimeError(f"linrec launch failed: CUDA error {err} "
                           f"({lib.linrec_error_string(err).decode()})")
    linrec_cuda.launches += 1
    return out


linrec_cuda.launches = 0

"""ctypes binding of the CUDA flash-attention kernel (csrc/flash_attention.cu).

`flash_attention_cuda(q, k, v, causal=, window=)` launches on PyTorch's
current stream and counts its launches in `.launches`, and per route in
`.routes`, so a run can show that its prefills went through the kernel it
expects.  `route(q, k, v)` picks the kernel from shapes, dtype, strides and
alignment alone:

  "wgmma"  bf16 that TMA can describe (D and every batch, time and head
           stride a multiple of 8 elements and non-zero, q/k/v 16-byte
           aligned): flash_fwd_wgmma, TMA and wgmma, any D <= 256;
  "mma"    other bf16 with D <= 128: flash_fwd_mma (mma.sync);
  "fma"    fp32, and other bf16 with D > 128: flash_fwd_fma (fp32 FMAs).

The library is built from the sources at first call (kernels/build.py),
never at import.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from repro_torch.kernels.build import COMMON, load_library

SOURCES = [Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"]
HEADERS = [COMMON / "tma.cuh"]   # included by the source
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = ("fma", "mma", "wgmma")   # the C entry point's route codes 0, 1, 2
MAX_HEAD_DIM = 256
_LIB: list[ctypes.CDLL] = []   # loaded once per process


def library() -> ctypes.CDLL:
    if not _LIB:
        lib = load_library("flash_attention", SOURCES, HEADERS)
        fn = lib.flash_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int64] * 14
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                          ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _LIB.append(lib)
    return _LIB[0]


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Raise on shapes, dtypes and strides the kernel does not take: q
    (B, T, H, D), k/v (B, S, Hkv, D) of one dtype (fp32 or bf16), S == T,
    H % Hkv == 0, 1 <= D <= 256, head dim contiguous."""
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise TypeError(f"flash_attention_cuda: dtypes {q.dtype}, {k.dtype}, "
                        f"{v.dtype}; need one of fp32, bf16 for all three")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention_cuda: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}; need "
                         "(B, T, H, D) and two equal (B, S, Hkv, D)")
    B, T, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash_attention_cuda: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} differ in batch or head dim")
    if k.shape[1] != T:
        raise ValueError(f"flash_attention_cuda: S = {k.shape[1]} != T = {T};"
                         " the kernel takes self-attention (prefill) only")
    if k.shape[2] == 0 or H % k.shape[2]:
        raise ValueError(f"flash_attention_cuda: H = {H} is not a multiple "
                         f"of Hkv = {k.shape[2]}")
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention_cuda: head dim {D} outside "
                         f"1..{MAX_HEAD_DIM}")
    if B > 65535 or H > 65535 or T >= 2 ** 31:
        raise ValueError(f"flash_attention_cuda: B {B}, H {H}, T {T} beyond "
                         "the grid")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.shape[3] > 1 and t.stride(3) != 1:
            raise ValueError(f"flash_attention_cuda: {name}'s head dim must "
                             f"be contiguous (strides {t.stride()})")


def route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The kernel that takes these (checked) inputs: "wgmma", "mma" or
    "fma".  Reads only dtype, shape, strides and data pointers, so meta and
    CPU tensors answer as CUDA tensors of that layout would."""
    if q.dtype != torch.bfloat16:
        return "fma"
    D = q.shape[3]
    tma = D % 8 == 0 and all(
        s > 0 and s % 8 == 0 and t.data_ptr() % 16 == 0
        for t in (q, k, v) for s in t.stride()[:3])
    if tma:
        return "wgmma"
    return "mma" if D <= 128 else "fma"


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: int = 0) -> torch.Tensor:
    """q (B, T, H, D), k/v (B, T, Hkv, D) CUDA tensors as they lie (only
    the head dim need be contiguous) -> attention (B, T, H, D), contiguous,
    in q's dtype."""
    if q.device.type != "cuda" or k.device != q.device or \
            v.device != q.device:
        raise ValueError(f"flash_attention_cuda: q on {q.device}, k on "
                         f"{k.device}, v on {v.device}; all on one CUDA "
                         "device")
    check_inputs(q, k, v)
    if window < 0:
        raise ValueError(f"flash_attention_cuda: window {window} < 0")
    B, T, H, D = q.shape
    out = torch.empty(B, T, H, D, dtype=q.dtype, device=q.device)
    if B == 0 or T == 0 or H == 0:
        return out
    lib = library()
    name = route(q, k, v)
    strides = [s for t in (q, k, v) for s in t.stride()[:3]]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, T, H, k.shape[2], D, *strides, int(bool(causal)), int(window),
            1.0 / math.sqrt(D), _DTYPE_CODE[q.dtype], ROUTES.index(name),
            stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention launch ({name}) failed: CUDA error {err} "
            f"({lib.flash_attention_error_string(err).decode()})")
    flash_attention_cuda.launches += 1
    flash_attention_cuda.routes[name] += 1
    return out


flash_attention_cuda.launches = 0
flash_attention_cuda.routes = dict.fromkeys(ROUTES, 0)

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

Training (csrc/flash_attention_train.cu, a library of its own):
`flash_attention_train_fwd_cuda` runs flash_fwd_wgmma with the row
log-sum-exp saved, `flash_attention_train_bwd_cuda` the backward kernels
(dq; dk and dv), for inputs that `takes_grad` accepts: bf16 self attention
that TMA can describe, with 32 < D <= 128.  Each counts its calls in
`.launches`.  The training library holds only the padded head dim a call
needs (64 or 128), built at its first call.

The libraries are built from the sources at first call (kernels/build.py),
never at import.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from repro_torch.kernels.build import COMMON, load_library

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = [CSRC / "flash_attention.cu"]
TRAIN_SOURCES = [CSRC / "flash_attention_train.cu"]
HEADERS = [CSRC / "flash_wgmma.cuh", COMMON / "tma.cuh"]   # included by both
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = ("fma", "mma", "wgmma")   # the C entry point's route codes 0, 1, 2
MAX_HEAD_DIM = 256
_LIB: list[ctypes.CDLL] = []   # loaded once per process
_TRAIN_LIB: dict[int, ctypes.CDLL] = {}   # by padded head dim


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


def train_library(dp: int) -> ctypes.CDLL:
    """The training kernels for padded head dim `dp` (64 or 128), built
    with that head dim alone."""
    if dp not in _TRAIN_LIB:
        lib = load_library(f"flash_attention_train_d{dp}", TRAIN_SOURCES,
                           HEADERS, flags=(f"-DFLASH_TRAIN_DP={dp}",))
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        fwd = lib.flash_attention_train_fwd
        fwd.argtypes = ([p] * 6 + [i64] * 15
                        + [i32, i32, ctypes.c_float, p])
        fwd.restype = i32
        bwd = lib.flash_attention_train_bwd
        bwd.argtypes = ([p] * 11 + [i64] * 18
                        + [i32, i32, ctypes.c_float, p])
        bwd.restype = i32
        lib.flash_attention_train_error_string.argtypes = [i32]
        lib.flash_attention_train_error_string.restype = ctypes.c_char_p
        _TRAIN_LIB[dp] = lib
    return _TRAIN_LIB[dp]


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


def tma_strides(t: torch.Tensor) -> list[int]:
    """t's batch, time and head strides (elements) as the training kernels'
    TMA maps take them: a dim of size 1 addresses nothing, and its stride,
    which PyTorch leaves at any value (an output gradient of batch 1 comes
    with a batch stride of 1), is given the packed value of the dims inside
    it."""
    st = list(t.stride()[:3])
    inner = (t.stride(3), st[2], st[1])
    for d in (2, 1, 0):
        if t.shape[d] == 1:
            st[d] = t.shape[d + 1] * (st[d + 1] if d < 2 else inner[0])
    return st


def _tma_ok(t: torch.Tensor) -> bool:
    return (t.shape[3] % 8 == 0 and t.stride(3) == 1 and t.data_ptr() % 16 == 0
            and all(s > 0 and s % 8 == 0 for s in tma_strides(t)))


def takes_grad(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether the training kernels take these inputs: bf16 self attention
    (S == T, H a multiple of Hkv) with 32 < D <= 128 that TMA can describe
    (`tma_strides`; otherwise `route`'s "wgmma" test).  Smaller heads would
    spend over half the padded tensor work on zeros.  Reads only dtype,
    shape, strides and data pointers, so meta and CPU tensors answer as CUDA
    tensors of that layout would."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        return False
    B, T, H, D = q.shape
    return (q.dtype == k.dtype == v.dtype == torch.bfloat16
            and k.shape[0] == B and k.shape[1] == T and k.shape[3] == D
            and k.shape[2] > 0 and H % k.shape[2] == 0
            and 32 < D <= 128 and T > 0 and 0 < B <= 65535
            and 0 < H <= 65535 and all(_tma_ok(t) for t in (q, k, v)))


def _padded(T: int) -> int:
    return -(-T // 128) * 128   # the lse rows, padded to the forward's tile


def _train_dp(D: int) -> int:
    return 64 if D <= 64 else 128


def _raise(lib, err: int, what: str):
    if err != 0:
        raise RuntimeError(
            f"{what} failed: CUDA error {err} "
            f"({lib.flash_attention_train_error_string(err).decode()})")


def flash_attention_train_fwd_cuda(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, *, causal: bool = True,
                                   window: int = 0):
    """q (B, T, H, D), k/v (B, T, Hkv, D) CUDA tensors that `takes_grad`
    accepts -> (o (B, T, H, D) bf16 contiguous; o_lo, o's rounding
    residual (o + o_lo is the fp32 output to within 2^-17 of itself); lse
    (B, H, Tp) fp32 with Tp = T rounded up to 128: each row's natural
    log-sum-exp of its scaled scores, rows past T not written)."""
    if q.device.type != "cuda" or k.device != q.device or \
            v.device != q.device or not takes_grad(q, k, v) or window < 0:
        raise ValueError(
            f"flash_attention_train_fwd_cuda: q {tuple(q.shape)} {q.dtype} "
            f"on {q.device}, k {tuple(k.shape)}, window {window}: needs "
            "CUDA tensors the training kernels take (takes_grad)")
    B, T, H, D = q.shape
    Tp = _padded(T)
    o = torch.empty(B, T, H, D, dtype=q.dtype, device=q.device)
    o_lo = torch.empty_like(o)
    lse = torch.empty(B, H, Tp, dtype=torch.float32, device=q.device)
    lib = train_library(_train_dp(D))
    strides = [s for t in (q, k, v) for s in tma_strides(t)]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_train_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            o_lo.data_ptr(), lse.data_ptr(), B, T, H, k.shape[2], D, Tp,
            *strides,
            int(bool(causal)), int(window), 1.0 / math.sqrt(D), stream)
    _raise(lib, err, "flash_attention_train_fwd launch")
    flash_attention_train_fwd_cuda.launches += 1
    return o, o_lo, lse


def flash_attention_train_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, o: torch.Tensor,
                                   o_lo: torch.Tensor, lse: torch.Tensor,
                                   do: torch.Tensor, *,
                                   causal: bool = True, window: int = 0):
    """The gradients of o = attention(q, k, v) for the output gradient
    `do`, from the forward's o, o_lo and lse -> (dq, dk, dv), bf16
    contiguous in the shapes of q, k and v.  Deterministic: no atomics."""
    if not takes_grad(q, k, v) or do.shape != q.shape or \
            do.dtype != q.dtype or o.shape != q.shape or \
            o_lo.shape != q.shape or not o.is_contiguous() or \
            not o_lo.is_contiguous() or \
            lse.shape != (q.shape[0], q.shape[2], _padded(q.shape[1])):
        raise ValueError(
            f"flash_attention_train_bwd_cuda: q {tuple(q.shape)}, do "
            f"{tuple(do.shape)} {do.dtype}, o {tuple(o.shape)}, lse "
            f"{tuple(lse.shape)}: not the forward's")
    if not _tma_ok(do):
        do = do.clone(memory_format=torch.contiguous_format)
    B, T, H, D = q.shape
    Hkv = k.shape[2]
    dq = torch.empty(B, T, H, D, dtype=q.dtype, device=q.device)
    dk = torch.empty(B, T, Hkv, D, dtype=q.dtype, device=q.device)
    dv = torch.empty(B, T, Hkv, D, dtype=q.dtype, device=q.device)
    delta = torch.empty(lse.shape, dtype=torch.float32, device=q.device)
    lib = train_library(_train_dp(D))
    strides = [s for t in (q, k, v, do) for s in tma_strides(t)]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_train_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            o_lo.data_ptr(), lse.data_ptr(), do.data_ptr(),
            delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, T, H, Hkv, D, lse.shape[2],
            *strides, int(bool(causal)), int(window), 1.0 / math.sqrt(D),
            stream)
    _raise(lib, err, "flash_attention_train_bwd launch")
    flash_attention_train_bwd_cuda.launches += 1
    return dq, dk, dv


flash_attention_train_fwd_cuda.launches = 0
flash_attention_train_bwd_cuda.launches = 0

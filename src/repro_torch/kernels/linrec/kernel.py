"""ctypes binding of the CUDA linrec kernels (csrc/linrec.cu).

`linrec_cuda(a, b, h0)` launches on PyTorch's current stream and counts
its launches in `linrec_cuda.launches`, and per route in `.routes`, so a
run can show that its scans went through the kernel it expects.
`route(a, b)` picks the kernel from shapes, dtype, strides and alignment
alone:

  "tma"     a and b that TMA can describe (`tma_ok`), D of a strip (32)
            or more and T of a tile (32 steps) or more: linrec_tma, a
            ring of TMA loads feeding one warp a strip of 32 columns
            (both models' prefill scans);
  "column"  every other layout, and short T such as a decode step:
            linrec_column, one thread a column.

Both compute the same loop, so they are equal bit for bit.  The library
is built from the sources at first call (kernels/build.py), never at
import.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import COMMON, load_library

SOURCES = [Path(__file__).resolve().parent / "csrc" / "linrec.cu"]
HEADERS = [COMMON / "tma.cuh"]   # included by the source
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = ("column", "tma")   # the C entry point's route codes 0, 1
STRIP = 32                   # columns of one consumer warp of linrec_tma
TILE_T = 32                  # time steps of one of its TMA tiles
_LIB: list[ctypes.CDLL] = []   # loaded once per process


def library() -> ctypes.CDLL:
    if not _LIB:
        lib = load_library("linrec", SOURCES, HEADERS)
        lib.linrec_launch.argtypes = ([ctypes.c_void_p] * 4
                                      + [ctypes.c_int64] * 7
                                      + [ctypes.c_int, ctypes.c_int,
                                         ctypes.c_void_p])
        lib.linrec_launch.restype = ctypes.c_int
        lib.linrec_error_string.argtypes = [ctypes.c_int]
        lib.linrec_error_string.restype = ctypes.c_char_p
        _LIB.append(lib)
    return _LIB[0]


def tma_ok(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether TMA can describe (B, T, D) a and b, as linrec.cu's tma_ok
    decides: 16-byte aligned bases, batch and time strides positive
    multiples of 16 bytes (a stride over an axis of extent 1 is never
    read), D a multiple of 16 bytes (4 fp32, 8 bf16), d contiguous."""
    B, T, D = a.shape
    size = a.element_size()
    for t in (a, b):
        sb, st, sd = t.stride()
        if D > 1 and sd != 1:
            return False
        if t.data_ptr() % 16:
            return False
        for s, extent in ((st, T), (sb, B)):
            if extent > 1 and (s <= 0 or s * size % 16):
                return False
    return D * size % 16 == 0


def route(a: torch.Tensor, b: torch.Tensor) -> str:
    """The kernel that takes these (checked) inputs: "tma" or "column".
    Reads only shapes, strides and data pointers, so CPU tensors answer as
    CUDA tensors of that layout would."""
    B, T, D = a.shape
    if T >= TILE_T and D >= STRIP and tma_ok(a, b):
        return "tma"
    return "column"


def linrec_cuda(a: torch.Tensor, b: torch.Tensor,
                h0: torch.Tensor | None = None, *,
                route_name: str | None = None) -> torch.Tensor:
    """a, b (B, T, D) CUDA tensors of one dtype (fp32 or bf16), as they lie
    (only D need be contiguous); h0 (B, D) fp32 or None -> hs (B, T, D)
    fp32, contiguous.  `route_name` forces a route (a timing or a test
    compares the two); the kernel refuses one it cannot take."""
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
    name = route(a, b) if route_name is None else route_name
    if name not in ROUTES:
        raise ValueError(f"linrec_cuda: route {name!r}; have {ROUTES}")
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
            _DTYPE_CODE[a.dtype], ROUTES.index(name), stream)
    if err != 0:
        raise RuntimeError(f"linrec launch ({name}) failed: CUDA error {err} "
                           f"({lib.linrec_error_string(err).decode()})")
    linrec_cuda.launches += 1
    linrec_cuda.routes[name] += 1
    return out


linrec_cuda.launches = 0
linrec_cuda.routes = dict.fromkeys(ROUTES, 0)

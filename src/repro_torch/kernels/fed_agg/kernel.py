"""ctypes binding of the CUDA fed_agg kernel (csrc/fed_agg.cu).

`fed_agg_grouped_cuda(members, w)` merges K members' leaf lists in one
launch per `capacity()` (one for every tree the port merges), with the
weights passed by value, on PyTorch's current stream, and counts its
launches in `fed_agg_grouped_cuda.launches`, so a run can show that its
merges went through the kernel.  `fed_agg_cuda(x, w)` is a group of one.
`plan` and `pack` build a launch's table; they are pure Python.  The
library is built from the sources at first call (kernels/build.py), never
at import.
"""
from __future__ import annotations

import ctypes
import functools
import struct
from itertools import chain
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from repro_torch.kernels.build import load_library

SOURCES = [Path(__file__).resolve().parent / "csrc" / "fed_agg.cu"]
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
ITEMSIZE = {0: 4, 1: 2}           # bytes of an element, by dtype code
TILE_ELEMS = {0: 1024, 1: 2048}   # a tile: 256 threads x 16 bytes, by code
_LIB: list[ctypes.CDLL] = []   # loaded once per process


def library() -> ctypes.CDLL:
    if not _LIB:
        lib = load_library("fed_agg", SOURCES)
        lib.fed_agg_grouped_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_void_p]
        lib.fed_agg_grouped_launch.restype = ctypes.c_int
        lib.fed_agg_empty_launch.argtypes = [ctypes.c_void_p]
        lib.fed_agg_empty_launch.restype = ctypes.c_int
        for fn in (lib.fed_agg_capacity_slots, lib.fed_agg_capacity_parts):
            fn.argtypes = []
            fn.restype = ctypes.c_int
        lib.fed_agg_error_string.argtypes = [ctypes.c_int]
        lib.fed_agg_error_string.restype = ctypes.c_char_p
        _LIB.append(lib)
    return _LIB[0]


@functools.cache
def capacity() -> tuple[int, int]:
    """(member slots, parts) one launch takes: a tree of L leaves and K
    members is one launch while L <= parts and K * L <= slots."""
    lib = library()
    return lib.fed_agg_capacity_slots(), lib.fed_agg_capacity_parts()


def plan(tiles: Sequence[int], K: int, slots: int, parts: int
         ) -> list[list[tuple[int, int, int, int]]]:
    """Split a merge of K members over leaves of `tiles` tiles each into
    launches of at most `parts` parts and `slots` member slots: -> per
    launch its parts (leaf, k_lo, k_hi, first tile), leaves in order.  A
    leaf goes whole into one launch where a launch can hold it, else its
    members are split in k order over consecutive launches.  Leaves of no
    tile are left out."""
    launches: list[list[tuple[int, int, int, int]]] = []
    cur: list[tuple[int, int, int, int]] = []
    used = first = 0
    for leaf, n_tiles in enumerate(tiles):
        if n_tiles == 0:
            continue
        k = 0
        while k < K:
            if cur and (len(cur) == parts or used + K - k > slots):
                launches.append(cur)
                cur, used, first = [], 0, 0
            take = min(K - k, slots - used)
            cur.append((leaf, k, k + take, first))
            used += take
            first += n_tiles
            k += take
    if cur:
        launches.append(cur)
    return launches


def pack(launch, K: int, ptrs, outs, partials, sizes, codes, w32):
    """The C interface's table of one launch: -> (parts, x, w) lists.  A
    part is (out, acc, n, first tile, first slot, k, dtype code, partial)
    as FedAggPart's eight int64; x holds the member pointers slot by slot
    and w their fp32 weights.  ptrs[k][l] is member k's leaf l, outs[l] the
    leaf's output, partials[l] its fp32 partial sum (leaves split over
    launches), codes[l] its dtype code, w32 the K weights as fp32 values."""
    rows, x, w = [], [], []
    for leaf, k_lo, k_hi, first in launch:
        partial_out = k_hi < K
        rows.append((partials[leaf] if partial_out else outs[leaf],
                     partials[leaf] if k_lo > 0 else 0, sizes[leaf], first,
                     len(x), k_hi - k_lo, codes[leaf], int(partial_out)))
        x.extend(ptrs[k][leaf] for k in range(k_lo, k_hi))
        w.extend(w32[k_lo:k_hi])
    return rows, x, w


def fed_agg_grouped_cuda(members: Sequence[Sequence[torch.Tensor]],
                         weights) -> list[torch.Tensor]:
    """members[k][l]: leaf l of member k, contiguous fp32/bf16 CUDA tensors
    on one device, each leaf of one shape and dtype across members; weights
    K values on the host, rounded once to fp32 -> the merged leaves, views
    of one buffer, one launch per capacity().  It runs once a merge on the
    main path, where its host time is most of the merge's, so it reads
    each tensor's attributes once and builds the table from Python ints."""
    K = len(members)
    w32 = np.asarray(weights, dtype=np.float64).astype(np.float32)
    if K == 0 or w32.shape != (K,):
        raise ValueError(f"fed_agg_grouped_cuda: {K} members, weights of "
                         f"shape {w32.shape}; need K >= 1 and K weights")
    first = members[0]
    index = first[0].get_device() if len(first) else 0
    want = [(t.dtype, t.shape, True, index) for t in first]
    for k, member in enumerate(members):
        got = [(l.dtype, l.shape, l.is_contiguous(), l.get_device())
               for l in member]
        if got != want:
            raise ValueError(f"fed_agg_grouped_cuda: member {k}'s leaves "
                             f"(dtype, shape, contiguous, device) {got}; "
                             f"need {want}, on a CUDA device")
    if index < 0:
        raise ValueError("fed_agg_grouped_cuda: leaves on the CPU; all must "
                         "be on one CUDA device")
    if any(t.dtype not in DTYPE_CODE for t in first):
        dtypes = [t.dtype for t in first]
        raise TypeError(f"fed_agg_grouped_cuda: leaf dtypes {dtypes}; need "
                        "fp32 or bf16")
    # one output buffer, each leaf 16-byte aligned in it
    sizes, codes, starts, tiles, total = [], [], [], [], 0
    for t in first:
        n, c = t.numel(), DTYPE_CODE[t.dtype]
        sizes.append(n)
        codes.append(c)
        starts.append(total // ITEMSIZE[c])
        tiles.append(-(-n // TILE_ELEMS[c]))
        total += -(-n * ITEMSIZE[c] // 16) * 16
    device = torch.device("cuda", index)
    raw = torch.empty(total, dtype=torch.uint8, device=device)
    typed = {dt: raw.view(dt) for dt in {t.dtype for t in first}}
    out = [typed[t.dtype].as_strided(t.shape, t.stride(), at)
           for t, at in zip(first, starts)]
    slots, parts = capacity()
    launches = plan(tiles, K, slots, parts)
    partials = [0] * len(first)
    if K > slots:   # every leaf is split: an fp32 partial sum each
        at = np.cumsum([0] + [-(-n // 4) * 4 for n in sizes]).tolist()
        acc = torch.empty(at[-1], dtype=torch.float32, device=device)
        partials = [acc.data_ptr() + 4 * a for a in at[:-1]]
    ptrs = [[t.data_ptr() for t in member] for member in members]
    outs = [o.data_ptr() for o in out]
    tables = [pack(launch, K, ptrs, outs, partials, sizes, codes,
                   w32.tolist()) for launch in launches]
    if torch.cuda.current_device() == index:
        _launch(tables, index)
    else:
        with torch.cuda.device(index):
            _launch(tables, index)
    return out


def _launch(tables, index: int) -> None:
    """fed_agg_grouped_launch of each packed table on the current stream of
    device `index` (the current device); raise on a launch error."""
    lib = library()
    stream = torch._C._cuda_getCurrentRawStream(index)
    for rows, x, w in tables:
        err = lib.fed_agg_grouped_launch(
            struct.pack(f"{8 * len(rows)}q", *chain.from_iterable(rows)),
            len(rows), struct.pack(f"{len(x)}q", *x),
            struct.pack(f"{len(w)}f", *w), len(x), stream)
        if err != 0:
            raise RuntimeError(f"fed_agg launch failed: CUDA error {err} "
                               f"({lib.fed_agg_error_string(err).decode()})")
        fed_agg_grouped_cuda.launches += 1


def fed_agg_cuda(x: torch.Tensor, w) -> torch.Tensor:
    """x (K, N) contiguous fp32/bf16 CUDA tensor, w K weights on the host
    (a sequence, numpy array or CPU tensor) -> (N,) in x's dtype: a group
    of one leaf."""
    if x.dim() != 2 or x.shape[0] == 0:
        raise ValueError(f"fed_agg_cuda: x {tuple(x.shape)}; need (K, N), "
                         "K >= 1")
    if isinstance(w, torch.Tensor):
        if w.device.type != "cpu":
            raise ValueError(f"fed_agg_cuda: weights on {w.device}; they "
                             "are passed by value from the host")
        w = w.numpy()
    return fed_agg_grouped_cuda([[row] for row in x], w)[0]


fed_agg_grouped_cuda.launches = 0


def empty_launch() -> None:
    """One launch of an empty kernel on the current device's current
    stream: the floor a grouped launch is timed against."""
    err = library().fed_agg_empty_launch(torch._C._cuda_getCurrentRawStream(
        torch.cuda.current_device()))
    if err != 0:
        raise RuntimeError(f"empty launch failed: CUDA error {err}")

"""Weight/gradient compression for the cross-island exchange, port of
`repro.core.compression`.

Two quantisation SCALE LAYOUTS share one symmetric-int8 core (the quant8
kernels on CUDA, their plain version on the CPU; kernels/quant8):

  * **blockwise** (wire format) -- flatten, pad to a multiple of `block`,
    quantise (nblocks, block) with one fp32 scale per block.  The pad
    crosses the wire: `compressed_bytes` counts nblocks*block int8 payload
    plus 4 bytes per scale.
  * **rowwise** (the exchange's layout) -- one fp32 scale per last-dim
    channel; `q` keeps the input's shape.  Used by
    `federated.fl_aggregate_compressed`.

Top-k sparsification (`sparsify_topk` / `topk_mask`) composes with either
layout; `compress_tree(mode=...)` exposes "q8" | "topk" | "q8_topk".
`ErrorFeedback` accumulates the compression residual locally and adds it
to the next round's delta, so any of the modes is unbiased over time.
Every function takes `impl` ("auto" | "ref"), passed on to the quant8
kernels.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.quant8 import ops as q8ops
from repro_torch.tree import leaves, tree_map, unflatten_like

MODES = ("q8", "topk", "q8_topk")


def _dtype_name(dtype: torch.dtype) -> str:
    """'float32', 'bfloat16', ...: the reference's wire-dict dtype names."""
    return str(dtype).removeprefix("torch.")


# --------------------------------------------------------------------------
# Blockwise (wire format)
# --------------------------------------------------------------------------

def quantize_blockwise(x, *, block: int = 256, impl: str = "auto"):
    """x: any-shape float -> (int8 (nblocks, block), fp32 scales (nblocks,))."""
    return q8ops.quantize(x, block=block, impl=impl)


def dequantize_blockwise(q, scale, shape, *, impl: str = "auto"):
    return q8ops.dequantize(q, scale, tuple(shape), impl=impl)


# --------------------------------------------------------------------------
# Rowwise (per last-dim channel)
# --------------------------------------------------------------------------

def quantize_rowwise(x, *, impl: str = "auto"):
    """x: (..., C) float -> (int8 SAME shape, fp32 scales (..., 1))."""
    return q8ops.quantize_rowwise(x, impl=impl)


def dequantize_rowwise(q, scale, *, out_dtype=torch.float32,
                       impl: str = "auto"):
    return q8ops.dequantize_rowwise(q, scale, out_dtype=out_dtype, impl=impl)


# --------------------------------------------------------------------------
# Top-k sparsification
# --------------------------------------------------------------------------

def _k_of(n: int, k_frac: float) -> int:
    return max(1, min(n, int(math.ceil(k_frac * n))))


def sparsify_topk(x, *, k_frac: float = 0.05):
    """Keep the k = ceil(k_frac * n) largest-magnitude entries (wire form).
    Returns (idx int32 (k,), val fp32 (k,)) over the flattened x.  Ties at
    the k-th magnitude keep the lower index, as `jax.lax.top_k` does (a
    stable descending sort; `torch.topk` leaves the tie order open)."""
    flat = x.float().reshape(-1)
    k = _k_of(flat.shape[0], k_frac)
    idx = torch.sort(flat.abs(), descending=True, stable=True).indices[:k]
    return idx.to(torch.int32), flat[idx]


def topk_mask(x, *, k_frac: float = 0.05, batch_dims: int = 0):
    """Shape-preserving top-k: a boolean mask keeping, per batch element
    (leading `batch_dims` axes), every entry whose magnitude reaches the
    k-th largest.  Ties at the threshold keep a few extra entries; the
    mask depends only on the k-th value, so it equals the reference's."""
    xf = x.float().abs()
    flat = xf.reshape(tuple(x.shape[:batch_dims]) + (-1,))
    k = _k_of(flat.shape[-1], k_frac)
    kth = torch.topk(flat, k, dim=-1).values[..., -1]
    kth = kth.reshape(tuple(x.shape[:batch_dims])
                      + (1,) * (x.dim() - batch_dims))
    return xf >= kth.clamp_min(1e-30)   # all-zero input keeps nothing


# --------------------------------------------------------------------------
# Tree compression (mode = "q8" | "topk" | "q8_topk")
# --------------------------------------------------------------------------

def compress_tree(tree, *, mode: str = "q8", block: int = 256,
                  k_frac: float = 0.05, impl: str = "auto"):
    """tree -> tree of wire-format dicts (leaves become dicts).

    "q8":      {"q", "scale", "shape", "dtype"}          blockwise int8
    "topk":    {"idx", "val", "shape", "dtype"}          sparse fp32
    "q8_topk": {"idx", "q", "scale", "k", "shape", "dtype"}  sparse int8
    """
    if mode not in MODES:
        raise ValueError(f"unknown compression mode '{mode}' (use {MODES})")
    ls = leaves(tree)
    metas = [{"shape": tuple(l.shape), "dtype": _dtype_name(l.dtype)}
             for l in ls]
    if mode == "q8":         # every leaf in one grouped quantise
        out = [{"q": q, "scale": s, **meta} for (q, s), meta in
               zip(q8ops.quantize_grouped(ls, block=block, impl=impl), metas)]
        return unflatten_like(tree, out)
    sparse = [sparsify_topk(l, k_frac=k_frac) for l in ls]
    if mode == "topk":
        out = [{"idx": idx, "val": val, **meta}
               for (idx, val), meta in zip(sparse, metas)]
        return unflatten_like(tree, out)
    vals = q8ops.quantize_grouped([val for _, val in sparse], block=block,
                                  impl=impl)
    out = [{"idx": idx, "q": q, "scale": s, "k": int(idx.shape[0]), **meta}
           for (idx, _), (q, s), meta in zip(sparse, vals, metas)]
    return unflatten_like(tree, out)


def _is_cleaf(x):
    return isinstance(x, dict) and ("q" in x or "val" in x)


def _map_cleaves(fn, ctree):
    """fn applied to each wire-format dict of a compressed tree."""
    if _is_cleaf(ctree):
        return fn(ctree)
    return {k: _map_cleaves(fn, ctree[k]) for k in sorted(ctree)}


def decompress_tree(ctree, *, impl: str = "auto"):
    ds = []
    _map_cleaves(ds.append, ctree)
    quantized = [d for d in ds if "q" in d]   # one grouped dequantise
    vals = iter(q8ops.dequantize_grouped(
        [d["q"] for d in quantized], [d["scale"] for d in quantized],
        [(d["k"],) if "idx" in d else d["shape"] for d in quantized],
        impl=impl))

    def one(d):
        n = math.prod(d["shape"])
        if "idx" in d:
            val = d["val"] if "val" in d else next(vals)   # topk, q8_topk
            x = torch.zeros(n, dtype=torch.float32, device=val.device)
            x[d["idx"].long()] = val
            x = x.reshape(d["shape"])
        else:                                    # q8
            x = next(vals)
        return x.to(getattr(torch, d["dtype"]))
    return _map_cleaves(one, ctree)


def roundtrip_islands(stacked, base, *, mode: str = "q8", block: int = 256,
                      k_frac: float = 0.05, impl: str = "auto"):
    """Round-trip every island's delta-from-base through the compressed
    wire: leaves are stacked (P, ...), and each island's delta is
    compressed/decompressed INDEPENDENTLY (per-island payloads -- top-k
    selection and block scales never straddle island boundaries).  Returns
    base + decode(encode(member - base)) per island, stacked: what a robust
    aggregator must fold and its finite/quarantine gate threshold."""
    P = leaves(stacked)[0].shape[0]
    outs = []
    for i in range(P):
        pi = tree_map(lambda l: l[i], stacked)
        bi = tree_map(lambda l: l[i], base)
        delta = tree_map(lambda p, b: p.float() - b.float(), pi, bi)
        delta = decompress_tree(compress_tree(delta, mode=mode, block=block,
                                              k_frac=k_frac, impl=impl),
                                impl=impl)
        outs.append(tree_map(lambda b, d: (b.float() + d).to(b.dtype),
                             bi, delta))
    return tree_map(lambda *xs: torch.stack(xs), *outs)


def compressed_bytes(tree, *, mode: str = "q8", block: int = 256,
                     k_frac: float = 0.05) -> int:
    """Bytes on the wire for the compressed form.  `block`/`k_frac` must
    match the `compress_tree(...)` call the wire actually uses.

    "none" counts the uncompressed storage bytes.  "q8" counts the PADDED
    int8 payload (nblocks*block + 4*nblocks bytes).  "q8_rowwise" counts
    the exchange layout: n int8 + one fp32 scale per last-dim row.  Works
    on any leaf with `shape` and `dtype` (tensors, numpy arrays)."""
    total = 0
    for leaf in leaves(tree):
        shape = tuple(leaf.shape)
        n = math.prod(shape)
        if mode == "none":
            total += n * leaf.dtype.itemsize
            continue
        if mode == "q8_rowwise":
            rows = n // shape[-1] if shape else 1
            total += n + 4 * rows
            continue
        nblocks = -(-n // block)
        if mode == "q8":
            total += nblocks * block + 4 * nblocks
        elif mode == "topk":
            total += 8 * _k_of(n, k_frac)            # int32 idx + fp32 val
        elif mode == "q8_topk":
            k = _k_of(n, k_frac)
            kb = -(-k // block)
            total += 4 * k + kb * block + 4 * kb     # idx + padded q8 vals
        else:
            raise ValueError(f"unknown compression mode '{mode}'")
    return total


class ErrorFeedback:
    """Stateful residual accumulator: delta_sent = C(delta + residual).
    Works for any `compress_tree` mode -- the residual carries both the
    quantisation error and the entries top-k dropped."""

    def __init__(self, like_tree, *, impl: str = "auto"):
        self.impl = impl
        self.residual = tree_map(
            lambda x: torch.zeros(tuple(x.shape), dtype=torch.float32,
                                  device=x.device), like_tree)

    def compress(self, delta, *, mode: str = "q8", block: int = 256,
                 k_frac: float = 0.05):
        carried = tree_map(lambda d, r: d.float() + r, delta, self.residual)
        ctree = compress_tree(carried, mode=mode, block=block, k_frac=k_frac,
                              impl=self.impl)
        deq = decompress_tree(_map_cleaves(lambda d: dict(d, dtype="float32"),
                                          ctree), impl=self.impl)
        self.residual = tree_map(lambda c, q: c - q, carried, deq)
        return ctree

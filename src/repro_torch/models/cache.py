"""CacheSpec: the one place the contiguous KV-cache convention lives, as in
the reference's `repro.models.cache`.

A CacheSpec is `layout[:shards]/dtype`:

  layout  "replicated" | "head" | "ring" | "paged" -- on one device the
          first two are the same cache; "ring" splits the sequence dim
          into `shards` segments that decode merges by log-sum-exp
          (layers.ring_decode_attention); "paged" is the block pool
          (core/paging.py, `paged_attention_cache_defs`).
  shards  ring only: the static segment count.  0 means the ambient
          mesh's "model" axis (dist/sharding.use_mesh); with no mesh,
          one segment.
  dtype   "bf16", or "int8": rowwise-quantised K/V with one fp32 scale per
          (token, head) over head_dim, on the port's quant8 kernels.

Each leaf carries its logical axes (`kv_axes`), which the planning
layer (dist/sharding.py, dist/policy.py) resolves against a mesh:
`resolve` says when a spec degrades on a mesh, `cache_bytes` is what the
serve policy scores, and `constrain_cache` re-asserts a spec's placement
on an ambient mesh.

Caches are written IN PLACE: `write_kv` updates the preallocated tensors
of the cache it is given and returns a new dict around the same tensors,
as the JAX loops' donated buffers let XLA do.  A cache handed to a decode
step is consumed by it.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.param import pdef

CACHE_LAYOUTS = ("replicated", "head", "ring", "paged")
CACHE_DTYPES = ("bf16", "int8")

#: decode headroom appended to non-windowed prefill caches
PREFILL_DECODE_MARGIN = 128


@dataclasses.dataclass(frozen=True)
class CacheSpec:
    layout: str = "head"
    dtype: str = "bf16"
    shards: int = 0          # ring segment count; 0 = one segment here

    def __post_init__(self):
        if self.layout not in CACHE_LAYOUTS:
            raise ValueError(f"unknown cache layout '{self.layout}'; "
                             f"known: {CACHE_LAYOUTS}")
        if self.dtype not in CACHE_DTYPES:
            raise ValueError(f"unknown cache dtype '{self.dtype}'; "
                             f"known: {CACHE_DTYPES}")
        if self.shards and self.layout != "ring":
            raise ValueError("shards only applies to the ring layout")

    @property
    def quantized(self) -> bool:
        return self.dtype == "int8"

    @property
    def name(self) -> str:
        s = f":{self.shards}" if self.shards else ""
        return f"{self.layout}{s}/{self.dtype}"

    @classmethod
    def parse(cls, s) -> "CacheSpec":
        """"auto" | "layout[:shards]/dtype" | CacheSpec (passthrough)."""
        if isinstance(s, cls):
            return s
        if s is None or s == "auto":
            return cls()
        layout, _, dtype = str(s).partition("/")
        layout, _, shards = layout.partition(":")
        return cls(layout=layout, dtype=dtype or "bf16",
                   shards=int(shards) if shards else 0)


def spec_of(cfg) -> CacheSpec:
    """The model config's cache spec (ModelConfig.cache_spec string)."""
    return CacheSpec.parse(getattr(cfg, "cache_spec", "auto"))


def kv_axes(spec: CacheSpec):
    """Logical axes of one (batch, seq, kv_heads, head_dim) cache leaf.

    ring puts an EXPLICIT ("model",) tuple on the seq dim: explicit
    tuples bind in resolution pass 0 (dist/sharding.py), so "model" is
    claimed before the kv_heads priority wave can take it and the heads
    dim falls back to replicated -- exactly the ring contract.
    """
    if spec.layout == "ring":
        return ("batch", ("model",), "kv_heads", None)
    if spec.layout == "replicated":
        return ("batch", "kv_seq", None, None)
    return ("batch", "kv_seq", "kv_heads", None)


def ring_segments(spec: CacheSpec, seq_len: int) -> int:
    """Static ring segment count for a cache of `seq_len` slots: the
    spec's shard count (the ambient mesh's "model" size when unset, 1
    with no mesh), reduced to the largest power-of-two divisor of
    seq_len."""
    if spec.layout != "ring":
        return 1
    from repro_torch.dist.sharding import mesh_axis_size
    n = spec.shards or mesh_axis_size("model")
    while n > 1 and seq_len % n:
        n //= 2
    return max(n, 1)


def attention_cache_defs(cfg, batch: int, seq_len: int,
                         spec: CacheSpec | str | None = None):
    """Cache leaves (per layer) under a CacheSpec.  bf16: {k, v, len};
    int8 adds per-(token, head) fp32 scales {k_scale, v_scale}."""
    spec = CacheSpec.parse(spec) if spec is not None else spec_of(cfg)
    keep = min(cfg.window, seq_len) if cfg.window else seq_len
    ax = kv_axes(spec)
    kv = (batch, keep, cfg.num_kv_heads, cfg.head_dim)
    kv_dtype = torch.int8 if spec.quantized else torch.bfloat16
    d = {
        "k": pdef(kv, ax, dtype=kv_dtype, init="zeros"),
        "v": pdef(kv, ax, dtype=kv_dtype, init="zeros"),
        "len": pdef((batch,), ("batch",), dtype=torch.int32, init="zeros"),
    }
    if spec.quantized:
        sc = (batch, keep, cfg.num_kv_heads, 1)
        d["k_scale"] = pdef(sc, ax, dtype=torch.float32, init="zeros")
        d["v_scale"] = pdef(sc, ax, dtype=torch.float32, init="zeros")
    return d


def paged_attention_cache_defs(cfg, batch, num_blocks, block_size,
                               max_blocks_per_seq):
    """Paged-cache leaves (per layer): one block POOL shared by ALL
    sequences plus per-slot block tables and lengths.  Memory scales with
    the pool (total tokens resident), not max_batch * max_len.  The pool
    is bf16 only, as in the reference.  It holds num_blocks + 1 blocks:
    the last is a sink for the writes of rows at position -1
    (layers.paged_kv_write), which no block table names."""
    kv = (num_blocks + 1, block_size, cfg.num_kv_heads, cfg.head_dim)
    ax = (None, None, "kv_heads", None)
    return {
        "kp": pdef(kv, ax, dtype=torch.bfloat16, init="zeros"),
        "vp": pdef(kv, ax, dtype=torch.bfloat16, init="zeros"),
        "bt": pdef((batch, max_blocks_per_seq), ("batch", None),
                   dtype=torch.int32, init="zeros"),
        "len": pdef((batch,), ("batch",), dtype=torch.int32, init="zeros"),
    }


def resolve(spec: CacheSpec | str, cfg, mesh) -> tuple[CacheSpec, str]:
    """Effective spec on `mesh` + a note when the request degrades.

    "head" with kv_heads %% model != 0 cannot head-shard; the resolver
    reports it and callers offer "ring" as the candidate that always
    divides.
    """
    from repro_torch.dist.sharding import mesh_sizes
    spec = CacheSpec.parse(spec)
    m = mesh_sizes(mesh).get("model", 1)
    if spec.layout == "head" and m > 1 and cfg.num_kv_heads % m:
        return spec, (f"kv_heads={cfg.num_kv_heads} % model={m} != 0: "
                      f"head layout degrades to replicated ({m}-way "
                      f"replication of the cache); use ring")
    if spec.layout == "ring":
        n = spec.shards or m
        if n <= 1:
            return spec, "ring with a 1-wide model axis == replicated"
    return spec, ""


def cache_bytes(cfg, batch: int, seq_len: int,
                spec: CacheSpec | str | None, mesh, rules=None,
                num_layers: int | None = None) -> float:
    """Analytic per-device cache bytes for a spec on a mesh: the leaf
    defs resolved through the sharding rules, summed over layers (the
    number dist/policy.py scores (weight x cache) products with)."""
    from repro_torch.dist.policy import sharded_bytes
    per_layer = attention_cache_defs(cfg, batch, seq_len, spec)
    L = num_layers if num_layers is not None else cfg.num_layers
    return sharded_bytes(per_layer, mesh, rules) * L


def constrain_cache(cache, spec: CacheSpec | str | None):
    """Re-assert the spec's placement on cache leaves against the ambient
    mesh (dist/sharding.constrain: a no-op without one).  The port's
    model code does not call it per step (dist/sharding.py says why)."""
    from repro_torch.dist.sharding import constrain
    spec = CacheSpec.parse(spec) if spec is not None else CacheSpec()
    ax = kv_axes(spec)
    out = dict(cache)
    for key in ("k", "v", "k_scale", "v_scale"):
        if key in out:
            out[key] = constrain(out[key], ax)
    return out


def quantize_kv(x, *, impl: str = "auto"):
    """(..., D) bf16 -> ((..., D) int8, (..., 1) fp32 scales): the quant8
    kernel for CUDA tensors, its plain version for CPU tensors."""
    from repro_torch.kernels.quant8 import ops
    return ops.quantize_rowwise(x, impl=impl)


def dequantize_kv(q, scale, out_dtype=torch.bfloat16, *, impl: str = "auto"):
    """Inverse of quantize_kv."""
    from repro_torch.kernels.quant8 import ops
    return ops.dequantize_rowwise(q, scale, out_dtype=out_dtype, impl=impl)


def quantize_kv_pair(kk, vv, *, impl: str = "auto"):
    """quantize_kv of K and V in one grouped call (one kernel launch):
    -> ((kq, ks), (vq, vs))."""
    from repro_torch.kernels.quant8 import ops
    return tuple(ops.quantize_rowwise_grouped([kk, vv], impl=impl))


def read_kv(cache, *, impl: str = "auto"):
    """Cache leaves -> (k, v) bf16 views (dequantised when int8, K and V
    in one grouped call)."""
    if "k_scale" in cache:
        from repro_torch.kernels.quant8 import ops
        return tuple(ops.dequantize_rowwise_grouped(
            [cache["k"], cache["v"]], [cache["k_scale"], cache["v_scale"]],
            out_dtype=torch.bfloat16, impl=impl))
    return cache["k"], cache["v"]


def _pad_seq(x, target):
    pad = target - x.shape[1]
    if pad <= 0:
        return x
    return torch.cat([x, x.new_zeros((x.shape[0], pad) + x.shape[2:])],
                     dim=1)


def pack_prefill_cache(cfg, kk, vv, *, window: int,
                       spec: CacheSpec | None = None, impl: str = "auto"):
    """Pack full-sequence K/V (B, T, Hkv, D) into a fresh decode cache.

    window: ring-buffer trim to the last `window` positions (decode
    overwrites slot len %% window); else pad PREFILL_DECODE_MARGIN slots
    of decode headroom, rounded up so ring segment counts divide.
    """
    spec = spec or spec_of(cfg)
    B, T = kk.shape[0], kk.shape[1]
    if window and T >= window:
        kk, vv = kk[:, -window:], vv[:, -window:]
        keep = window
    else:
        keep = T + PREFILL_DECODE_MARGIN
        n = spec.shards if spec.layout == "ring" else 0
        if n:
            keep = -(-keep // n) * n
    cache = {"len": torch.full((B,), T, dtype=torch.int32,
                               device=kk.device)}
    if spec.quantized:
        (kq, ks), (vq, vs) = quantize_kv_pair(kk, vv, impl=impl)
        cache.update(k=_pad_seq(kq, keep), v=_pad_seq(vq, keep),
                     k_scale=_pad_seq(ks, keep), v_scale=_pad_seq(vs, keep))
    else:
        cache.update(k=_pad_seq(kk, keep), v=_pad_seq(vv, keep))
    return cache


def _update_rows(buf, rows, slots):
    """buf[b, slots[b]:slots[b] + C] = rows[b] for every b, in place.  A
    start past the end is clamped so the rows fit, as
    lax.dynamic_update_slice clamps."""
    B, C = rows.shape[0], rows.shape[1]
    start = slots.to(torch.int64).clamp(0, buf.shape[1] - C)
    idx = start[:, None] + torch.arange(C, device=buf.device)[None, :]
    bidx = torch.arange(B, device=buf.device)[:, None].expand(B, C)
    buf[bidx, idx] = rows.to(buf.dtype)


def write_kv(cache, kk, vv, slots, *, impl: str = "auto"):
    """Write K/V rows (B, C, Hkv, D) at per-batch `slots` (sequences at
    different positions coexist in one batch: continuous batching), IN
    PLACE into the cache's tensors; -> a new dict around them.
    Quantisation follows the cache's own leaves (an int8 cache carries
    k_scale/v_scale).  The reference's `spec=` only re-asserts sharding,
    which one device does not have."""
    out = dict(cache)
    if "k_scale" in cache:
        (kq, ks), (vq, vs) = quantize_kv_pair(kk, vv, impl=impl)
        for key, rows in (("k", kq), ("v", vq), ("k_scale", ks),
                          ("v_scale", vs)):
            _update_rows(out[key], rows, slots)
    else:
        _update_rows(out["k"], kk, slots)
        _update_rows(out["v"], vv, slots)
    return out

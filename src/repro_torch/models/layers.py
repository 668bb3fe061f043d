"""Core neural layers of the dense LMs, port of `repro.models.layers`.

Conventions (the reference's):
  * activations bf16, softmax/normalisation statistics fp32;
  * attention tensors are (batch, seq, heads, head_dim);
  * every layer is a plain function f(params_subtree, x, ...) -> y;
  * decode uses a cache + per-row positions.

Self-attention over a whole sequence (train, prefill) goes to the
`flash_attention` kernel for every length (`select_attention`); the
reference's XLA routes (`attention_full`, the blockwise scans) are not
ported.  The reference's `constrain(...)` sharding hints are no-ops on one
device and are left out.  Kernel ops take `impl="auto"|"ref"`, threaded
from `lm_apply`.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import cache as kvcache
from repro_torch.models.param import pdef

# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------


def rmsnorm(x, scale, eps=1e-6):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def layernorm(x, scale, bias, eps=1e-5):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def norm_defs(cfg):
    d = {"scale": pdef((cfg.d_model,), (None,), init="ones")}
    if cfg.norm == "layernorm":
        d["bias"] = pdef((cfg.d_model,), (None,), init="zeros")
    return d


def apply_norm(p, x):
    if "bias" in p:
        return layernorm(x, p["scale"], p["bias"])
    return rmsnorm(x, p["scale"])


# --------------------------------------------------------------------------
# Activations
# --------------------------------------------------------------------------

def _gelu_tanh(x):
    # jax.nn.gelu defaults to the tanh approximation; F.gelu's default is
    # the exact erf form
    return F.gelu(x, approximate="tanh")


def act_fn(name):
    return {
        "silu": F.silu,
        "gelu": _gelu_tanh,
        "gelu_plain": _gelu_tanh,
        "relu2": lambda x: F.relu(x).square(),
    }[name]


# --------------------------------------------------------------------------
# RoPE (full + partial/"2d" fraction, as in ChatGLM)
# --------------------------------------------------------------------------

def rope_apply(x, positions, theta=10_000.0, fraction=1.0):
    """x: (..., T, H, D); positions: (..., T) int. Rotates first
    `fraction*D` dims, passes the rest through (ChatGLM partial rotary).
    Angles are fp32; `x1 * cos` promotes bf16 to fp32 before the cast back,
    as in the reference."""
    d = x.shape[-1]
    rot = int(d * fraction)
    rot -= rot % 2
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    half = rot // 2
    # theta stays a Python scalar: a tensor made from it on the card would
    # be a blocking host-to-device copy on every call
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    # positions (..., T) -> (..., T, 1, half): broadcast over heads
    ang = positions.float()[..., None, None] * freq
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x_rot[..., :half], x_rot[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1.to(x.dtype), y2.to(x.dtype), x_pass], dim=-1)


# --------------------------------------------------------------------------
# Attention
# --------------------------------------------------------------------------

def decode_attention(q, k_cache, v_cache, cache_len):
    """Single-step decode: q (B,1,H,D) over cache (B,S,Hkv,D); positions
    >= cache_len are masked (an SWA ring buffer keeps only `window`
    positions, so S == window and the length mask is all there is to
    apply).  Scores and softmax in fp32 (the reference's
    preferred_element_type), probabilities cast to the activation dtype
    before PV; the PV sum is fp32 and rounds once."""
    B, _, H, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = H // Hkv
    qg = q.reshape(B, Hkv, G, D)
    scale = 1.0 / math.sqrt(D)
    s = torch.einsum("bhgd,bshd->bhgs", qg.float(), k_cache.float()) * scale
    kpos = torch.arange(S, device=q.device)
    valid = kpos[None, :] < cache_len[:, None]  # (B,S)
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1).to(q.dtype)
    out = torch.einsum("bhgs,bshd->bhgd", p.float(), v_cache.float())
    return out.to(q.dtype).reshape(B, 1, H, D)


def ring_decode_attention(q, k_cache, v_cache, cache_len, *, segments):
    """Seq-segmented decode: decode_attention's math with the seq dim split
    into `segments` slices merged by log-sum-exp (one global max, so the
    probabilities equal decode_attention's up to fp32 summation order).
    On one device the segments share the card; the layout is kept so the
    ring cache spec runs and is held against the reference."""
    B, _, H, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    n = segments
    Sn = S // n
    G = H // Hkv
    qg = q.reshape(B, Hkv, G, D)
    ks = k_cache.reshape(B, n, Sn, Hkv, D)
    vs = v_cache.reshape(B, n, Sn, Hkv, D)
    scale = 1.0 / math.sqrt(D)
    s = torch.einsum("bhgd,bnshd->bnhgs", qg.float(), ks.float()) * scale
    kpos = (torch.arange(n, device=q.device)[:, None] * Sn
            + torch.arange(Sn, device=q.device)[None, :])           # (n,Sn)
    valid = kpos[None] < cache_len[:, None, None]                  # (B,n,Sn)
    s = torch.where(valid[:, :, None, None, :], s, torch.full_like(s, -1e30))
    m_seg = s.amax(dim=-1)                     # (B,n,Hkv,G) segment-local
    M = m_seg.amax(dim=1, keepdim=True)        # cross-segment (tiny)
    p = torch.exp(s - M[..., None])
    l = p.sum(dim=-1).sum(dim=1)               # (B,Hkv,G) cross-segment
    probs = (p / l[:, None, :, :, None]).to(q.dtype)
    out = torch.einsum("bnhgs,bnshd->bhgd", probs.float(), vs.float())
    return out.to(q.dtype).reshape(B, 1, H, D)


def select_attention(q, k, v, *, causal=True, window=0, impl="auto"):
    """Self-attention over a whole sequence (T == S) runs on the
    flash_attention kernel for CUDA tensors, at every length, and on its
    plain version for CPU tensors.  The reference routes to XLA paths here
    (attention_full up to 4,096 tokens, blockwise scans above); the kernel
    computes the same function.  Queries at an offset into their keys
    (contiguous chunk_prefill) need the XLA routes, which come back with
    the paged slice."""
    if q.shape[1] != k.shape[1]:
        raise NotImplementedError(
            "attention with T != S (chunk_prefill): the paged serving slice")
    return flash_ops.flash_attention(q, k, v, causal=causal, window=window,
                                     impl=impl)


# --------------------------------------------------------------------------
# Attention block (params + apply, train/prefill/decode)
# --------------------------------------------------------------------------

def attention_defs(cfg):
    d = cfg.d_model
    H, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    defs = {
        "wq": pdef((d, H, Dh), ("embed", "heads", None), fan_in_axes=(0,)),
        "wk": pdef((d, Hkv, Dh), ("embed", "kv_heads", None), fan_in_axes=(0,)),
        "wv": pdef((d, Hkv, Dh), ("embed", "kv_heads", None), fan_in_axes=(0,)),
        "wo": pdef((H, Dh, d), ("heads", None, "embed_tp"), fan_in_axes=(0, 1)),
    }
    if cfg.qkv_bias:
        defs["bq"] = pdef((H, Dh), ("heads", None), init="zeros")
        defs["bk"] = pdef((Hkv, Dh), ("kv_heads", None), init="zeros")
        defs["bv"] = pdef((Hkv, Dh), ("kv_heads", None), init="zeros")
    return defs


def attention_apply(p, cfg, x, positions, *, mode="train", cache=None,
                    impl="auto"):
    """mode: train/prefill (full seq, causal) or decode (T==1, uses
    cache).  Returns (out, new_cache).  Decode writes the new K/V row into
    `cache`'s tensors in place (models/cache.py)."""
    if mode == "chunk_prefill" or (cache is not None and "kp" in cache):
        raise NotImplementedError("paged serving: a later slice")
    window = cfg.window
    q = torch.einsum("btd,dhk->bthk", x, p["wq"])
    if "bq" in p:
        q = q + p["bq"]
    q = rope_apply(q, positions, cfg.rope_theta, cfg.rope_fraction)
    kk = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    vv = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if "bk" in p:
        kk = kk + p["bk"]
        vv = vv + p["bv"]
    kk = rope_apply(kk, positions, cfg.rope_theta, cfg.rope_fraction)

    new_cache = cache
    if mode == "decode":
        cache_len = cache["len"]
        S = cache["k"].shape[1]
        if window and S == window:
            slots = cache_len % window                # ring buffer
        else:
            slots = cache_len
        # per-row slot writes: sequences at different positions coexist in
        # one batch (continuous batching, serve_loop); int8 caches quantise
        # the new row and update the rowwise scales alongside
        new_cache = kvcache.write_kv(cache, kk, vv, slots, impl=impl)
        new_cache["len"] = cache_len + 1
        k_read, v_read = kvcache.read_kv(new_cache, impl=impl)
        # SWA ring buffers (S == window) are one segment; segment the seq
        # dim otherwise
        spec = kvcache.spec_of(cfg)
        n = kvcache.ring_segments(spec, S) if not window else 1
        if n > 1:
            out = ring_decode_attention(q, k_read, v_read, cache_len + 1,
                                        segments=n)
        else:
            out = decode_attention(q, k_read, v_read, cache_len + 1)
    else:
        out = select_attention(q, kk, vv, window=window, impl=impl)
        if mode == "prefill":
            new_cache = kvcache.pack_prefill_cache(cfg, kk, vv, window=window,
                                                   impl=impl)
    y = torch.einsum("bthk,hkd->btd", out, p["wo"])
    return y, new_cache


# --------------------------------------------------------------------------
# Dense MLP (gated or plain)
# --------------------------------------------------------------------------

def mlp_defs(cfg):
    gated = cfg.act in ("silu", "gelu")
    d, f = cfg.d_model, cfg.d_ff
    defs = {
        "w_up": pdef((d, f), ("embed", "ffn"), fan_in_axes=(0,)),
        "w_down": pdef((f, d), ("ffn", "embed_tp"), fan_in_axes=(0,)),
    }
    if gated:
        defs["w_gate"] = pdef((d, f), ("embed", "ffn"), fan_in_axes=(0,))
    return defs


def mlp_apply(p, cfg, x):
    h = torch.matmul(x, p["w_up"])
    if "w_gate" in p:
        g = torch.matmul(x, p["w_gate"])
        h = act_fn(cfg.act)(g) * h
    else:
        h = act_fn(cfg.act)(h)
    return torch.matmul(h, p["w_down"])


# --------------------------------------------------------------------------
# Embedding / unembedding
# --------------------------------------------------------------------------

def embed_defs(cfg):
    defs = {"tok": pdef((cfg.vocab_size, cfg.d_model),
                        (None, ("data", "model")), init="embed")}
    if not cfg.tie_embeddings:
        defs["unembed"] = pdef((cfg.d_model, cfg.vocab_size),
                               ("embed", "vocab"), fan_in_axes=(0,))
    return defs


def embed_apply(p, tokens):
    return F.embedding(tokens, p["tok"])


def unembed_apply(p, x):
    """Logits stay in activation dtype (bf16), as in the reference."""
    w = p.get("unembed")
    if w is None:
        w = p["tok"].T
    return torch.matmul(x, w)

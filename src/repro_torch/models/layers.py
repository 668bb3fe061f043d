"""Core neural layers of the LMs (dense, MoE, VLM, the enc-dec's blocks),
port of `repro.models.layers`.

Conventions (the reference's):
  * activations bf16, softmax/normalisation statistics fp32;
  * attention tensors are (batch, seq, heads, head_dim);
  * every layer is a plain function f(params_subtree, x, ...) -> y;
  * decode uses a cache + per-row positions.

Attention over a whole sequence (train, prefill: T == S, no query
offset) goes to the `flash_attention` kernel for every length
(`select_attention`): causal self attention, and non-causal for an
encoder and for cross attention whose keys have the queries' length.
A call that carries a gradient (`grad_requested`: training) over a whole
sequence goes to the differentiable `flash_attention_train` (forward and
backward kernels) on the card when its inputs are what those kernels
take (`grad_takes_kernel`: bf16 on the TMA route, 32 < D <= 128).
Cross attention over keys of another length, queries at an offset into
their keys (contiguous chunk_prefill), and the other gradient calls
(CPU and meta tensors among them) take the reference's plain routes, as
plain torch:
`attention_full` up to 4,096 positions, the blockwise scans
(`flash_attention_xla`, `flash_attention_xla_triangular`) above.  The
paged cache (`paged_kv_write`, `paged_gather_kv`, `paged_chunk_attention`)
is plain torch too, as the reference's is plain jnp, and so is the MoE
layer (`moe_apply`: router, dispatch and combine gathers, expert
products; the reference computes it outside Pallas).  The reference's
`constrain(...)` sharding hints are no-ops on one device and are left
out.  Kernel ops take `impl="auto"|"ref"`, threaded from `lm_apply`.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import cache as kvcache
from repro_torch.models.param import pdef
from repro_torch.tree import leaves as _leaves


def grad_requested(*tensors) -> bool:
    """Whether a call carries a gradient: autograd is on and one of
    `tensors` (None allowed) requires grad.  Such a call takes a route
    that autograd differentiates: the plain routes, or for attention the
    training kernels where they take it (`select_attention`); the
    forward-only kernel ops raise on it.  The mode is not the signal: an
    encoder runs mode="train" inside a prefill."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def remat(cfg, fn, *args, x, lp):
    """fn(*args) for one layer (or super-block) of params `lp` on the
    activations `x`; when cfg.remat and a gradient is requested, under
    `torch.utils.checkpoint` (non-reentrant), which keeps the layer's
    inputs and recomputes its inside in the backward pass, as the
    reference's `jax.checkpoint` of the layer body does."""
    if cfg.remat and grad_requested(x, *_leaves(lp)):
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


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


def attention_full(q, k, v, *, causal=True, window=0, q_offset=0):
    """Exact attention with a materialised score matrix, the reference's
    route up to 4,096 positions.  q: (B,T,H,D), k,v: (B,S,Hkv,D), GQA by
    head grouping; query t sits at position t + q_offset (an int or a
    0-d tensor).  Scores and softmax in fp32; the probabilities are
    rounded to q's dtype before PV, where the reference rounds them (the
    flash_attention kernel, the T == S route, keeps them fp32)."""
    B, T, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, T, Hkv, G, D)
    scale = 1.0 / math.sqrt(D)
    scores = torch.einsum("bthgd,bshd->bhgts", qg.float(), k.float()) * scale
    qpos = torch.arange(T, device=q.device) + q_offset
    kpos = torch.arange(S, device=q.device)
    mask = torch.ones((T, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window:
        mask &= kpos[None, :] > qpos[:, None] - window
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhgts,bshd->bthgd", probs.float(), v.float())
    return out.to(q.dtype).reshape(B, T, H, D)


def _online_softmax(qblk, qpos, k, v, kv_blocks, kv_block, *, causal,
                    window, out_dtype):
    """One query block (B, Cq, Hkv, G, D) at positions qpos (Cq,) through
    the online softmax over the kv blocks `kv_blocks`, at the
    reference's rounding points: fp32 scores and statistics, P rounded
    to the activation dtype before PV, each block's PV rounded to it too,
    fp32 accumulator.  -> (B, Cq, Hkv, G, D)."""
    B, Cq, Hkv, G, D = qblk.shape
    scale = 1.0 / math.sqrt(D)
    m = torch.full((B, Hkv, G, Cq), -math.inf, device=qblk.device)
    l = torch.zeros((B, Hkv, G, Cq), device=qblk.device)
    acc = torch.zeros((B, Hkv, G, Cq, D), device=qblk.device)
    for jb in kv_blocks:
        kblk = k[:, jb * kv_block:(jb + 1) * kv_block]
        vblk = v[:, jb * kv_block:(jb + 1) * kv_block]
        kpos = jb * kv_block + torch.arange(kv_block, device=qblk.device)
        s = torch.einsum("bthgd,bshd->bhgts", qblk.float(),
                         kblk.float()) * scale
        msk = torch.ones((Cq, kv_block), dtype=torch.bool,
                         device=qblk.device)
        if causal:
            msk &= kpos[None, :] <= qpos[:, None]
        if window:
            msk &= kpos[None, :] > qpos[:, None] - window
        s = torch.where(msk, s, torch.full_like(s, -1e30))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bhgts,bshd->bhgtd", p.to(out_dtype).float(),
                          vblk.float()).to(out_dtype)
        acc = acc * corr[..., None] + pv.float()
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    # (B,Hkv,G,Cq,D) -> (B,Cq,Hkv,G,D)
    return out.permute(0, 3, 1, 2, 4).to(out_dtype)


def flash_attention_xla(q, k, v, *, causal=True, window=0, q_offset=0,
                        q_block=1024, kv_block=1024):
    """The reference's memory-bounded blockwise attention (its route above
    4,096 positions), as plain torch loops over blocks: never holds more
    than a (q_block, kv_block) score tile per (batch, head).  With a
    window only the kv blocks the window reaches are visited; the first
    of them needs q_offset on the host (a tensor offset is read once).
    T and S must be multiples of their block sizes, as in the
    reference."""
    B, T, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    q_block, kv_block = min(q_block, T), min(kv_block, S)
    if T % q_block or S % kv_block:
        raise ValueError(f"T={T} and S={S} must be multiples of q_block="
                         f"{q_block} and kv_block={kv_block}")
    nq, nkv = T // q_block, S // kv_block
    n_win = nkv
    if window:
        q_offset = int(q_offset)
        n_win = min((window + q_block + kv_block - 2) // kv_block + 1, nkv)
    qg = q.reshape(B, nq, q_block, Hkv, G, D)
    outs = []
    for iq in range(nq):
        qpos = (iq * q_block + torch.arange(q_block, device=q.device)
                + q_offset)
        first = 0
        if window:
            lo = iq * q_block + q_offset - (window - 1)
            first = min(max(lo // kv_block, 0), nkv - n_win)
        outs.append(_online_softmax(
            qg[:, iq], qpos, k, v, range(first, first + n_win), kv_block,
            causal=causal, window=window, out_dtype=q.dtype))
    return torch.stack(outs, dim=1).reshape(B, T, H, D)


def flash_attention_xla_triangular(q, k, v, *, q_offset=0, block=1024):
    """The reference's causal blockwise attention on its balanced
    triangular schedule: query block p is paired with block nq-1-p, and
    the pair visits p + 1 and nq - p kv blocks, the causal triangle and no
    more.  Requires T == S, T % block == 0 and an even block count."""
    B, T, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    if T != S or T % block or (T // block) % 2:
        raise ValueError(f"triangular schedule needs T == S (T={T}, S={S})"
                         f" and an even number of {block}-blocks")
    nq = T // block
    qg = q.reshape(B, nq, block, Hkv, G, D)
    outs = [None] * nq
    for p in range(nq // 2):
        for row in (p, nq - 1 - p):
            qpos = (row * block + torch.arange(block, device=q.device)
                    + q_offset)
            outs[row] = _online_softmax(
                qg[:, row], qpos, k, v, range(row + 1), block, causal=True,
                window=0, out_dtype=q.dtype)
    return torch.stack(outs, dim=1).reshape(B, T, H, D)


def paged_kv_write(kp, vp, bt, kk, vv, positions):
    """Scatter per-token K/V into the paged pool, IN PLACE.

    kp/vp: (NB + 1, BS, Hkv, D) block pool shared by ALL sequences, whose
    last block is a sink that no table names (`paged_attention_cache_defs`);
    bt: (B, nbmax) block tables; kk/vv: (B, C, Hkv, D) new K/V;
    positions: (B, C) ABSOLUTE positions, -1 marking rows whose writes
    are dropped (a bucketed tail chunk's padding, a free slot's decode).
    A dropped row is written to the sink's first row instead, so every
    index is in range and no host synchronisation is needed; the first NB
    blocks end as JAX's `mode="drop"` scatter leaves them.  Distinct
    sequences write distinct blocks (shared prefix blocks are read-only),
    so the kept writes never collide.  -> (kp, vp)."""
    nb, bs = kp.shape[0], kp.shape[1]
    pos = positions.long()
    page = torch.gather(bt.long(), 1, pos.clamp(min=0) // bs)   # (B, C)
    flat = torch.where(pos >= 0, page * bs + pos % bs,
                       (nb - 1) * bs).reshape(-1)
    for pool, new in ((kp, kk), (vp, vv)):
        pool.view(nb * bs, *pool.shape[2:]).index_copy_(
            0, flat, new.reshape(-1, *new.shape[2:]).to(pool.dtype))
    return kp, vp


def paged_gather_kv(kp, vp, bt):
    """Gather each sequence's K/V view from the block pool: -> (B,
    nbmax*BS, Hkv, D) each.  Unallocated table entries (0) gather block
    0's contents; callers mask by length, so they get no weight."""
    nb, bs = kp.shape[0], kp.shape[1]
    B = bt.shape[0]
    idx = (bt.long()[:, :, None] * bs
           + torch.arange(bs, device=bt.device)[None, None]).reshape(B, -1)
    kf = kp.reshape(nb * bs, *kp.shape[2:])
    vf = vp.reshape(nb * bs, *vp.shape[2:])
    return kf[idx], vf[idx]


def paged_chunk_attention(q, k_seq, v_seq, positions):
    """Exact causal attention of a prefill CHUNK over the paged view.
    q: (B, C, H, D); k_seq/v_seq: (B, S, Hkv, D) gathered pages (holding
    this chunk's K/V and any shared-prefix blocks); positions: (B, C)
    absolute query positions (-1: padding, whose output is discarded).
    Scores (C, S) in fp32; P rounded to q's dtype before PV, as in the
    reference."""
    B, C, H, D = q.shape
    S, Hkv = k_seq.shape[1], k_seq.shape[2]
    G = H // Hkv
    qg = q.reshape(B, C, Hkv, G, D)
    scale = 1.0 / math.sqrt(D)
    s = torch.einsum("bthgd,bshd->bhgts", qg.float(), k_seq.float()) * scale
    kpos = torch.arange(S, device=q.device)
    mask = kpos[None, None, :] <= positions[:, :, None]          # (B, C, S)
    s = torch.where(mask[:, None, None], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1).to(q.dtype)
    out = torch.einsum("bhgts,bshd->bthgd", p.float(), v_seq.float())
    return out.to(q.dtype).reshape(B, C, H, D)


def select_attention(q, k, v, *, causal=True, window=0, q_offset=0,
                     impl="auto"):
    """Route one attention call, by shape, as the reference routes it.

    T == S with no query offset (the int 0: train, prefill) runs on the
    flash_attention kernel for CUDA tensors at every length, and on its
    plain version for CPU tensors; both keep P in fp32 through PV.  Any
    other call -- an int offset other than 0, or an offset given as a
    tensor (contiguous chunk_prefill passes the cache length) -- takes the
    reference's plain routes, which round P to the activation dtype:
    `attention_full` up to 4,096 positions, the triangular blockwise
    schedule for long causal T == S, `flash_attention_xla` otherwise.
    A call that carries a gradient takes `flash_attention_train` (the
    forward with its log-sum-exp saved and the backward kernels) for CUDA
    tensors that `grad_takes_kernel` accepts, and the plain routes
    otherwise, whose rounding points are the reference's; the counts of
    each are in `select_attention.grad_routes`."""
    T, S = q.shape[1], k.shape[1]
    if grad_requested(q, k, v):
        if q.device.type == "cuda" and grad_takes_kernel(
                q, k, v, q_offset=q_offset, impl=impl):
            _GRAD_ROUTES["kernel"] += 1
            return flash_ops.flash_attention_train(q, k, v, causal=causal,
                                                   window=window)
        _GRAD_ROUTES["plain"] += 1
    elif T == S and isinstance(q_offset, int) and q_offset == 0:
        return flash_ops.flash_attention(q, k, v, causal=causal,
                                         window=window, impl=impl)
    if max(T, S) <= 4096:
        return attention_full(q, k, v, causal=causal, window=window,
                              q_offset=q_offset)
    if (causal and not window and T == S and T % 1024 == 0
            and (T // 1024) % 2 == 0):
        return flash_attention_xla_triangular(q, k, v, q_offset=q_offset)
    return flash_attention_xla(q, k, v, causal=causal, window=window,
                               q_offset=q_offset)


# gradient-carrying calls by route, counted into the dict itself rather
# than through the name select_attention, so the count holds while a
# wrapper stands in its place (chip_smoke.py's planted faults)
_GRAD_ROUTES = {"kernel": 0, "plain": 0}
select_attention.grad_routes = _GRAD_ROUTES


def grad_takes_kernel(q, k, v, *, q_offset=0, impl="auto") -> bool:
    """Whether a call that carries a gradient would run on the training
    kernels were its tensors on the card: self attention over the whole
    sequence (T == S, the int offset 0), `impl="auto"`, and inputs the
    kernels take (`kernel.takes_grad`: bf16 on the TMA route, 32 < D <=
    128).  Reads shapes, dtypes and strides only, so meta tensors answer
    as CUDA tensors of that layout would."""
    return (impl == "auto" and q.shape[1] == k.shape[1]
            and isinstance(q_offset, int) and q_offset == 0
            and flash_kernel.takes_grad(q, k, v))


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
                    kv_source=None, causal=True, window=None, is_cross=False,
                    impl="auto"):
    """mode: train/prefill (full seq), decode (T==1, uses cache) or
    chunk_prefill (a chunk of a prompt at `positions`, into a paged cache
    {kp, vp, bt} or a contiguous spec'd cache).  Returns (out,
    new_cache).  Caches are written in place (models/cache.py).

    Cross attention (enc-dec): pass kv_source=enc_out in train/prefill,
    or is_cross=True in decode, whose cache then holds the STATIC encoder
    K/V built at prefill (never updated, no RoPE on q or k).  A prefill
    with kv_source returns that cross cache {k, v, len}: the K/V its
    attention used, which the reference computes a second time for the
    cache.  `causal` applies to self attention only; `window` defaults to
    the config's."""
    is_cross = is_cross or kv_source is not None
    window = cfg.window if window is None else window
    T = x.shape[1]
    q = torch.einsum("btd,dhk->bthk", x, p["wq"])
    if "bq" in p:
        q = q + p["bq"]
    if not is_cross:
        q = rope_apply(q, positions, cfg.rope_theta, cfg.rope_fraction)

    if is_cross and mode == "decode":
        # static encoder K/V cache: read-only attention over enc_len
        out = decode_attention(q, cache["k"], cache["v"], cache["len"])
        return torch.einsum("bthk,hkd->btd", out, p["wo"]), cache

    xs = kv_source if kv_source is not None else x
    kk = torch.einsum("bsd,dhk->bshk", xs, p["wk"])
    vv = torch.einsum("bsd,dhk->bshk", xs, p["wv"])
    if "bk" in p:
        kk = kk + p["bk"]
        vv = vv + p["bv"]
    if not is_cross:
        kk = rope_apply(kk, positions, cfg.rope_theta, cfg.rope_fraction)

    paged = cache is not None and "kp" in cache
    if paged and window:
        raise ValueError("paged cache does not support sliding windows")
    new_cache = cache
    if mode == "chunk_prefill" and paged:
        # scatter this chunk's K/V into the block pool, then exact
        # attention over the sequence's gathered view (which holds any
        # shared-prefix blocks: their positions are never recomputed)
        kp, vp = paged_kv_write(cache["kp"], cache["vp"], cache["bt"],
                                kk, vv, positions)
        k_seq, v_seq = paged_gather_kv(kp, vp, cache["bt"])
        out = paged_chunk_attention(q, k_seq, v_seq, positions)
        new_cache = {"kp": kp, "vp": vp}
    elif mode == "chunk_prefill":
        # contiguous chunked prefill (all rows at the same offset): write
        # the chunk's K/V at the current length, then attention of the
        # chunk over the cache at that offset
        cache_len = cache["len"]
        new_cache = kvcache.write_kv(cache, kk, vv, cache_len, impl=impl)
        new_cache["len"] = cache_len + T
        k_read, v_read = kvcache.read_kv(new_cache, impl=impl)
        out = select_attention(q, k_read, v_read, causal=True,
                               window=window, q_offset=cache_len[0],
                               impl=impl)
    elif mode == "decode" and paged:
        kp, vp, bt = cache["kp"], cache["vp"], cache["bt"]
        cache_len = cache["len"]
        paged_kv_write(kp, vp, bt, kk, vv, cache_len[:, None])
        k_seq, v_seq = paged_gather_kv(kp, vp, bt)
        out = decode_attention(q, k_seq, v_seq, cache_len + 1)
        new_cache = {"kp": kp, "vp": vp, "bt": bt, "len": cache_len + 1}
    elif mode == "decode":
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
        out = select_attention(q, kk, vv, causal=causal and kv_source is None,
                               window=window, impl=impl)
        if mode == "prefill" and kv_source is None:
            new_cache = kvcache.pack_prefill_cache(cfg, kk, vv, window=window,
                                                   impl=impl)
        elif mode == "prefill":
            new_cache = {"k": kk, "v": vv, "len": torch.full(
                (kk.shape[0],), kk.shape[1], dtype=torch.int32,
                device=kk.device)}
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
# MoE (gather-based dispatch, as the reference's: no (T, E, C) one-hot
# einsum; the expert products are batched matmuls over the experts)
# --------------------------------------------------------------------------

def moe_defs(cfg):
    d, f, E = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    return {
        "w_router": pdef((d, E), ("embed", None), dtype=torch.float32,
                         fan_in_axes=(0,)),
        "w_gate": pdef((E, d, f), ("experts", "embed", "expert_ffn"),
                       fan_in_axes=(1,)),
        "w_up": pdef((E, d, f), ("experts", "embed", "expert_ffn"),
                     fan_in_axes=(1,)),
        "w_down": pdef((E, f, d), ("experts", "expert_ffn", "embed"),
                       fan_in_axes=(1,)),
    }


def moe_capacity(cfg, tokens: int) -> int:
    """Slots per expert in a group of `tokens`.  capacity_factor <= 0 is
    DROPLESS: an expert takes at most one choice per token, so `tokens`
    slots never overflow.  Otherwise the ceiling of the factor's share,
    rounded up to a multiple of 8, at least 8."""
    if cfg.capacity_factor <= 0:
        return tokens
    c = int(math.ceil(tokens * cfg.experts_per_token / cfg.num_experts
                      * cfg.capacity_factor))
    return max(8, -(-c // 8) * 8)


def _moe_groups(B: int, T: int, min_tokens: int = 2048) -> int:
    """Largest divisor of B keeping >= min_tokens tokens per group: the
    groups in which routing and capacity are computed (the reference
    shards them over its data axis)."""
    g = B
    while g > 1 and (B * T) // g < min_tokens:
        g //= 2
    while B % g != 0:
        g -= 1
    return max(g, 1)


def one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """F.one_hot's int64 0/1 rows by a comparison: the same operations on
    every device (F.one_hot checks its indices' range on the host for a
    CPU tensor, scatters on a CUDA one and compares on meta), so a cost
    walk (dist/cost.py) of an MoE step reads the same on all three."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).long()


def moe_route(probs, k: int, C: int):
    """The integer routing of one MoE layer.  probs: (G, ng, E) fp32 ->
    gval (G, ng, k) fp32, the chosen probabilities normalised to sum 1;
    gidx (G, ng, k) int64, the experts, best first; pos (G, ng, k), each
    choice's slot in its expert; keep = pos < C.

    Among equal probabilities the lower expert comes first, as
    `lax.top_k` orders them (`torch.topk` promises no order for ties): a
    stable descending sort.  Positions are a slot-major cumsum: choice 0
    of every token in the group comes before choice 1 of any token."""
    G, ng, E = probs.shape
    srt = torch.sort(probs, dim=-1, descending=True, stable=True)
    gval, gidx = srt.values[..., :k], srt.indices[..., :k]
    gval = gval / gval.sum(-1, keepdim=True).clamp_min(1e-9)
    onehot = one_hot(gidx, E)                              # (G, ng, k, E)
    flat = onehot.transpose(1, 2).reshape(G, k * ng, E)
    pos_flat = flat.cumsum(1) - flat
    pos = pos_flat.reshape(G, k, ng, E).transpose(1, 2).gather(
        -1, gidx[..., None])[..., 0]
    return gval, gidx, pos, pos < C


def moe_router(p, xg):
    """Router probabilities (G, ng, E) of the grouped rows xg, in fp32."""
    return torch.softmax(torch.matmul(xg.float(), p["w_router"]), dim=-1)


def moe_dispatch(xg, gidx, pos, keep, E: int, C: int):
    """Gather each expert's slots: xg (G, ng, d) -> xe (E, G * C, d),
    expert-major.  An empty slot reads a zero row; a dropped choice
    writes its token to a discarded row E of slot_token."""
    G, ng, d = xg.shape
    dev = xg.device
    # slot_token[g, e, c]: the token (within group g) in slot c of expert
    # e, ng where the slot is empty
    slot = torch.where(keep, gidx, E) * C + torch.where(keep, pos, 0)
    tok = torch.arange(ng, device=dev)[None, :, None].expand(gidx.shape)
    slot_token = torch.full((G, (E + 1) * C), ng, dtype=torch.long,
                            device=dev)
    slot_token.scatter_(1, slot.reshape(G, -1), tok.reshape(G, -1))
    # rows of x padded by one zero row a group, in (E, G, C) order
    rows = (slot_token.view(G, E + 1, C)[:, :E].permute(1, 0, 2)
            + (torch.arange(G, device=dev) * (ng + 1))[None, :, None])
    x_pad = torch.cat([xg, xg.new_zeros(G, 1, d)], dim=1)
    return x_pad.reshape(-1, d).index_select(0, rows.reshape(-1)).view(
        E, G * C, d)


def moe_experts(p, cfg, xe):
    """The gated expert MLPs over their slots, batched over the experts:
    xe (E, S, d) -> ye (E * S + 1, d), the slots' outputs and one zero
    row after them (what a dropped choice reads)."""
    E, S, d = xe.shape
    h = act_fn(cfg.act)(torch.bmm(xe, p["w_gate"])) * torch.bmm(xe,
                                                                p["w_up"])
    if grad_requested(h, p["w_down"]):     # out= has no autograd
        y = torch.bmm(h, p["w_down"]).reshape(E * S, d)
        return torch.cat([y, y.new_zeros(1, d)])
    ye = torch.empty(E * S + 1, d, device=xe.device,
                     dtype=torch.promote_types(h.dtype, p["w_down"].dtype))
    ye[-1].zero_()
    torch.bmm(h, p["w_down"], out=ye[:-1].view(E, S, d))
    return ye


def moe_combine(ye, gval, gidx, pos, keep, C: int):
    """Each choice's slot output, weighted by gval (cast to ye's dtype)
    where kept, summed over the k choices in ye's dtype -> (G, ng, d)."""
    G, ng, k = gidx.shape
    E = (ye.shape[0] - 1) // (G * C)
    g_off = (torch.arange(G, device=ye.device) * C)[:, None, None]
    slot_id = torch.where(keep, gidx * (G * C) + g_off + pos, E * G * C)
    yk = ye.index_select(0, slot_id.reshape(-1)).view(G, ng, k, -1)
    return torch.einsum("gnkd,gnk->gnd", yk, gval.to(ye.dtype) * keep)


def moe_apply(p, cfg, x):
    """Top-k routed expert MLP with per-group capacity and token dropping
    -> (y, load-balance loss): router (fp32), routing, dispatch, experts,
    combine.  Every row of x is routed and takes capacity, padding rows
    included, as in the reference.  Dispatch and combine are row gathers
    (`index_select`) through a zero row that empty slots and dropped
    choices read."""
    B, T, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    G = _moe_groups(B, T)
    C = moe_capacity(cfg, B * T // G)
    xg = x.reshape(G, -1, d)
    probs = moe_router(p, xg)
    gval, gidx, pos, keep = moe_route(probs, k, C)
    ye = moe_experts(p, cfg, moe_dispatch(xg, gidx, pos, keep, E, C))
    y = moe_combine(ye, gval, gidx, pos, keep, C)
    aux = _load_balance_loss(probs.reshape(B * T, E),
                             one_hot(gidx, E).reshape(B * T, k, E), E, k)
    return y.reshape(B, T, d), aux


def _load_balance_loss(probs, onehot, E, k):
    """Switch-style auxiliary loss: E * sum(frac_tokens * frac_probs),
    every choice counted before drops."""
    frac_tokens = onehot.sum(dim=(0, 1)).float() / (probs.shape[0] * k)
    frac_probs = probs.mean(dim=0)
    return E * torch.sum(frac_tokens * frac_probs)


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

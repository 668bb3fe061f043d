"""Mamba-1 selective SSM (falcon-mamba-7b backbone), port of
`repro.models.ssm`, 3 modes (train / prefill / decode) as the dense LM.

The selective scan is a diagonal first-order linear recurrence
    h_t = a_t * h_{t-1} + b_t,     a_t = exp(dt_t * A),  b_t = dt_t B_t x_t
over (B, T, d_inner, N).  The reference evaluates it with a chunked
associative scan (`_chunked_linear_scan`); the port runs it on the
`linrec` kernel over the free (B, T, d_inner * N) view, one launch per
layer in prefill and one per layer in each decode step (T = 1, from the
cached state).  A call that carries a gradient (training) takes the
reference's chunked scan, ported here, which autograd differentiates; the
kernel has no backward.  With `cfg.remat` such a call checkpoints each
layer (`layers.remat`).  The rounding points of the reference are kept:
prefill rounds the conv output to the activation dtype before `silu`,
decode applies `silu` in fp32 and rounds after.

Layer params and caches stay stacked (L, ...) as in models/transformer.py;
the port loops over L in Python.  Decode writes each layer's conv window
and state into the stacked cache tensors in place.  A prefill cache always
holds `conv_width - 1` conv rows, left-padded with zeros for shorter
prompts (the rows the decode window expects; the reference keeps fewer).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.linrec import ops as linrec_ops
from repro_torch.models import layers as L
from repro_torch.models.param import layer_params, pdef, stack_defs
from repro_torch.tree import tree_map


def _dt_rank(cfg) -> int:
    return max(1, math.ceil(cfg.d_model / 16))


def mamba_defs(cfg):
    d, di, N, w = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.conv_width
    r = _dt_rank(cfg)
    return {
        "w_in": pdef((d, 2 * di), ("embed", "ssm_inner"), fan_in_axes=(0,)),
        "conv_w": pdef((w, di), (None, "ssm_inner")),
        "conv_b": pdef((di,), ("ssm_inner",), init="zeros"),
        "w_x": pdef((di, r + 2 * N), ("ssm_inner", None), fan_in_axes=(0,)),
        "w_dt": pdef((r, di), (None, "ssm_inner"), fan_in_axes=(0,)),
        # softplus(-4.6) ~ 0.01
        "b_dt": pdef((di,), ("ssm_inner",), init="scalar:-4.6"),
        "a_log": pdef((di, N), ("ssm_inner", None), dtype=torch.float32,
                      init="scalar:0.5"),
        "d_skip": pdef((di,), ("ssm_inner",), dtype=torch.float32,
                       init="ones"),
        "w_out": pdef((di, d), ("ssm_inner", "embed_tp"), fan_in_axes=(0,)),
    }


def _causal_conv(x, w, b):
    """Depthwise causal conv as the reference computes it: shifted copies
    summed in fp32 in tap order. x: (B,T,C) -> (B,T,C) in x's dtype."""
    width, T = w.shape[0], x.shape[1]
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(width):
        shifted = F.pad(x, (0, 0, width - 1 - i, 0))[:, :T]
        y = y + shifted.float() * w[i].float()
    return (y + b.float()).to(x.dtype)


def conv_state(x, width: int):
    """The decode conv window after a prefill of x (B,T,C): its last
    width - 1 rows, left-padded with zeros when T < width - 1; a copy, so
    the prefill's activations are freed."""
    keep = width - 1
    tail = x[:, max(x.shape[1] - keep, 0):]
    return F.pad(tail, (0, 0, keep - tail.shape[1], 0)).contiguous()


def softplus(x):
    """jax.nn.softplus: log(1 + exp(x)) as logaddexp(x, 0)."""
    return torch.logaddexp(x, x.new_zeros(()))


def _ab(p, cfg, xc, xdb):
    """a, b of the scan, (B,T,di,N) fp32; `xdb` = xc @ w_x."""
    N, r = cfg.ssm_state, _dt_rank(cfg)
    dt_lowrank, B_ssm = xdb[..., :r], xdb[..., r:r + N]
    dt = softplus(torch.einsum("btr,rd->btd", dt_lowrank, p["w_dt"]).float()
                  + p["b_dt"].float())
    A = -torch.exp(p["a_log"].float())
    a = (dt[..., None] * A).exp_()            # in place: one (B,T,di,N) buffer
    b = (dt * xc.float())[..., None] * B_ssm.float()[:, :, None, :]
    return a, b


def _interleave(a, b):
    """Along axis 1: a[0], b[0], a[1], b[1], ... (a one longer or equal)."""
    m = b.shape[1]
    ab = torch.stack([a[:, :m], b], dim=2).reshape(
        (a.shape[0], 2 * m) + a.shape[2:])
    return ab if a.shape[1] == m else torch.cat([ab, a[:, m:]], dim=1)


def _associative_scan(combine, elems):
    """`jax.lax.associative_scan` over axis 1, its recursion step for step
    (pairs combined, the odd half scanned, the even half filled in): the
    reference's products and sums in its order, to a few ulp (XLA may
    fuse a product into its sum)."""
    n = elems[0].shape[1]
    if n < 2:
        return elems
    odd = _associative_scan(combine, combine([e[:, 0:-1:2] for e in elems],
                                             [e[:, 1::2] for e in elems]))
    rest = [e[:, 2::2] for e in elems]
    even = combine([e[:, :-1] for e in odd] if n % 2 == 0 else odd, rest)
    even = [torch.cat([e[:, :1], r], dim=1) for e, r in zip(elems, even)]
    return [_interleave(e, o) for e, o in zip(even, odd)]


def _combine(left, right):
    (al, bl), (ar, br) = left, right
    return [al * ar, bl * ar + br]


def _chunked_linear_scan(a, b, h0, chunk):
    """h_t = a_t*h_{t-1} + b_t over axis 1, port of the reference's
    `ssm._chunked_linear_scan`: per chunk of `chunk` steps an associative
    scan of the (a, b) pairs, the state carried across chunks.  a, b:
    (B,T,...), h0: (B,...) -> (hs (B,T,...), hT).  Differentiable by
    autograd: the route of a call that carries a gradient, where the
    linrec kernel has no backward.  Unlike the reference it takes any T
    (a last chunk may be shorter)."""
    h, outs = h0, []
    for c in range(0, a.shape[1], chunk):
        acum, bcum = _associative_scan(_combine, [a[:, c:c + chunk],
                                                  b[:, c:c + chunk]])
        hs = acum * h[:, None] + bcum
        outs.append(hs)
        h = hs[:, -1]
    return torch.cat(outs, dim=1), h


def _scan(a, b, h0, impl):
    """The selective scan of a, b (B,T,...) from h0 (B,...) or None
    (zeros): the linrec kernel op, or `_chunked_linear_scan` (chunks of
    256, the reference's) for a call that carries a gradient."""
    if L.grad_requested(a, b, h0):
        if h0 is None:
            h0 = a.new_zeros((a.shape[0],) + a.shape[2:])
        return _chunked_linear_scan(a, b, h0, 256)[0]
    B, T = a.shape[0], a.shape[1]
    hs = linrec_ops.linrec(a.reshape(B, T, -1), b.reshape(B, T, -1),
                           None if h0 is None else h0.reshape(B, -1),
                           impl=impl)
    return hs.view(a.shape)


def _ssm_inner(p, cfg, xc, z, h0, impl="auto"):
    """xc: conv+silu output (B,T,di); h0: (B,di,N) or None (zeros) ->
    (y (B,T,di), hT (B,di,N))."""
    N, r = cfg.ssm_state, _dt_rank(cfg)
    xdb = torch.einsum("btd,dr->btr", xc, p["w_x"])
    C_ssm = xdb[..., r + N:]
    a, b = _ab(p, cfg, xc, xdb)
    hs = _scan(a, b, h0, impl)
    del a, b                                  # 2 x (B,T,di,N) fp32
    hT = hs[:, -1].clone()
    y = torch.einsum("btdn,btn->btd", hs, C_ssm.float())
    del hs
    y = y + p["d_skip"].float() * xc.float()
    y = (y * F.silu(z.float())).to(xc.dtype)
    return y, hT


def mamba_apply(p, cfg, x, *, mode="train", cache=None, impl="auto"):
    """x: (B,T,d). Returns (out, new_cache); decode updates `cache`'s conv
    and state tensors in place."""
    B, T, _ = x.shape
    di, w = cfg.d_inner, cfg.conv_width
    xz = torch.einsum("btd,de->bte", x, p["w_in"])
    xi, z = xz[..., :di], xz[..., di:]

    if mode == "decode":
        win = torch.cat([cache["conv"], xi], dim=1)        # (B,w,di)
        xc = torch.einsum("bwd,wd->bd", win.float(), p["conv_w"].float())
        xc = F.silu(xc + p["conv_b"].float())
        xc = xc.to(x.dtype)[:, None]                       # (B,1,di)
        y, hT = _ssm_inner(p, cfg, xc, z, cache["h"], impl)
        cache["conv"].copy_(win[:, 1:])
        cache["h"].copy_(hT)
        new_cache = {"conv": cache["conv"], "h": cache["h"],
                     "len": cache["len"] + 1}
    else:
        xc = F.silu(_causal_conv(xi, p["conv_w"], p["conv_b"])
                    .float()).to(x.dtype)
        y, hT = _ssm_inner(p, cfg, xc, z, None, impl)
        new_cache = None
        if mode == "prefill":
            new_cache = {
                "conv": conv_state(xi, w),
                "h": hT,
                "len": torch.full((B,), T, dtype=torch.int32,
                                  device=x.device),
            }
    out = torch.einsum("btd,de->bte", y, p["w_out"])
    return out, new_cache


def _ssm_block(lp, cfg, x, mode, cache, impl):
    h = L.apply_norm(lp["ln"], x)
    y, new_cache = mamba_apply(lp["mamba"], cfg, h, mode=mode, cache=cache,
                               impl=impl)
    return x + y, new_cache


def ssm_block_defs(cfg):
    return {"ln": L.norm_defs(cfg), "mamba": mamba_defs(cfg)}


def ssm_lm_defs(cfg):
    return {
        "embed": L.embed_defs(cfg),
        "layers": stack_defs(ssm_block_defs(cfg), cfg.num_layers),
        "final_norm": L.norm_defs(cfg),
    }


def ssm_cache_defs(cfg, batch: int, seq_len: int):
    per_layer = {
        "conv": pdef((batch, cfg.conv_width - 1, cfg.d_inner),
                     ("batch", None, "ssm_inner"), init="zeros"),
        "h": pdef((batch, cfg.d_inner, cfg.ssm_state),
                  ("batch", "ssm_inner", None), dtype=torch.float32,
                  init="zeros"),
        "len": pdef((batch,), ("batch",), dtype=torch.int32, init="zeros"),
    }
    return stack_defs(per_layer, cfg.num_layers)


def ssm_lm_apply(params, cfg, batch_inputs, *, mode="train", cache=None,
                 impl="auto"):
    if mode not in ("train", "prefill", "decode"):
        raise NotImplementedError(f"mode {mode!r}")
    x = L.embed_apply(params["embed"], batch_inputs["tokens"])
    new_caches = []
    for i in range(cfg.num_layers):
        lp = layer_params(params["layers"], i)
        lc = tree_map(lambda a: a[i], cache) if mode == "decode" else None
        x, new_cache = L.remat(cfg, _ssm_block, lp, cfg, x, mode, lc, impl,
                               x=x, lp=lp)
        if mode == "prefill":
            new_caches.append(new_cache)
        elif mode == "decode":
            new_caches.append(new_cache["len"])

    if mode == "prefill":
        x = x[:, -1:]  # serving needs only the last position's logits
    x = L.apply_norm(params["final_norm"], x)
    logits = L.unembed_apply(params["embed"], x)
    if mode == "train":
        return logits, 0.0
    if mode == "decode":
        # conv windows and states were written in place into the stack
        return logits, {**cache, "len": torch.stack(new_caches)}
    return logits, tree_map(lambda *ls: torch.stack(ls), *new_caches)

"""Mamba-1 selective SSM (falcon-mamba-7b backbone), port of
`repro.models.ssm`, 3 modes (train / prefill / decode) as the dense LM.

The selective scan is a diagonal first-order linear recurrence
    h_t = a_t * h_{t-1} + b_t,     a_t = exp(dt_t * A),  b_t = dt_t B_t x_t
over (B, T, d_inner, N).  The reference evaluates it with a chunked
associative scan (`_chunked_linear_scan`); the port runs it on the
`linrec` kernel over the free (B, T, d_inner * N) view, one launch per
layer in prefill and one per layer in each decode step (T = 1, from the
cached state).  The rounding points of the reference are kept: prefill
rounds the conv output to the activation dtype before `silu`, decode
applies `silu` in fp32 and rounds after.

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
from repro_torch.models.param import pdef, stack_defs
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


def _ssm_inner(p, cfg, xc, z, h0, impl="auto"):
    """xc: conv+silu output (B,T,di); h0: (B,di,N) or None (zeros) ->
    (y (B,T,di), hT (B,di,N))."""
    B, T, di = xc.shape
    N, r = cfg.ssm_state, _dt_rank(cfg)
    xdb = torch.einsum("btd,dr->btr", xc, p["w_x"])
    C_ssm = xdb[..., r + N:]
    a, b = _ab(p, cfg, xc, xdb)
    hs = linrec_ops.linrec(
        a.view(B, T, di * N), b.view(B, T, di * N),
        None if h0 is None else h0.reshape(B, di * N), impl=impl)
    del a, b                                  # 2 x (B,T,di,N) fp32
    hs = hs.view(B, T, di, N)
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
        lp = tree_map(lambda a: a[i], params["layers"])
        lc = tree_map(lambda a: a[i], cache) if mode == "decode" else None
        h = L.apply_norm(lp["ln"], x)
        y, new_cache = mamba_apply(lp["mamba"], cfg, h, mode=mode, cache=lc,
                                   impl=impl)
        x = x + y
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

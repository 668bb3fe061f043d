"""Griffin-style hybrid (recurrentgemma-9b), port of `repro.models.rglru`:
RG-LRU recurrent blocks + local sliding-window attention in a 2:1 pattern,
each followed by a gated MLP.

38 layers = 12 super-blocks of [rec, rec, attn] (stacked (12, ...) as the
reference scans them; the port loops in Python) + a tail of [rec, rec].
The RG-LRU's diagonal recurrence runs on the `linrec` kernel (D =
lru_width), one launch per recurrent layer per prefill or decode step (a
call that carries a gradient takes `ssm._chunked_linear_scan`, and with
`cfg.remat` checkpoints each super-block, as the reference does; the
tail pairs are not checkpointed, in the reference either);
local attention runs on `flash_attention` with the config's window in
prefill and on the ring-buffer decode of models/layers.py.  Decode writes
the recurrent conv windows and states and the attention K/V rows into the
stacked cache tensors in place.  The reference's rounding points are kept:
the decode conv has no activation, prefill's conv output is rounded to the
activation dtype, and `gelu` is the tanh form.
"""
from __future__ import annotations

import torch

from repro_torch.models import cache as kvcache
from repro_torch.models import layers as L
from repro_torch.models.param import layer_params, pdef, stack_defs
from repro_torch.models.ssm import _causal_conv, _scan, conv_state, softplus
from repro_torch.tree import tree_map

_C_RGLRU = 8.0


def rglru_defs(cfg):
    d, r = cfg.d_model, cfg.lru_width
    return {
        "w_x": pdef((d, r), ("embed", "lru_width"), fan_in_axes=(0,)),
        "w_y": pdef((d, r), ("embed", "lru_width"), fan_in_axes=(0,)),
        "conv_w": pdef((cfg.conv_width, r), (None, "lru_width")),
        "conv_b": pdef((r,), ("lru_width",), init="zeros"),
        "w_rgate": pdef((r, r), ("lru_width", None), fan_in_axes=(0,)),
        "b_rgate": pdef((r,), (None,), init="zeros"),
        "w_igate": pdef((r, r), ("lru_width", None), fan_in_axes=(0,)),
        "b_igate": pdef((r,), (None,), init="zeros"),
        "lam": pdef((r,), (None,), dtype=torch.float32, init="scalar:-1.0"),
        "w_out": pdef((r, d), ("lru_width", "embed_tp"), fan_in_axes=(0,)),
    }


def rglru_apply(p, cfg, x, *, mode="train", cache=None, impl="auto"):
    """Griffin recurrent block. x: (B,T,d) -> (out, new_cache)."""
    B, T, _ = x.shape
    xb = torch.einsum("btd,dr->btr", x, p["w_x"])
    yb = torch.einsum("btd,dr->btr", x, p["w_y"])

    if mode == "decode":
        win = torch.cat([cache["conv"], xb], dim=1)         # (B,w,r)
        xc = torch.einsum("bwr,wr->br", win.float(), p["conv_w"].float())
        xc = (xc + p["conv_b"].float()).to(x.dtype)[:, None]
    else:
        xc = _causal_conv(xb, p["conv_w"], p["conv_b"])

    rg = torch.sigmoid(
        (torch.einsum("btr,rs->bts", xc, p["w_rgate"])
         + p["b_rgate"]).float())
    ig = torch.sigmoid(
        (torch.einsum("btr,rs->bts", xc, p["w_igate"])
         + p["b_igate"]).float())
    log_a = -_C_RGLRU * softplus(p["lam"].float()) * rg
    a = torch.exp(log_a)                                     # (B,T,r)
    gated_x = ig * xc.float()
    b = torch.sqrt(torch.clamp(1.0 - torch.square(a), min=1e-9)) * gated_x

    h0 = cache["h"] if mode == "decode" else None
    hs = _scan(a, b, h0, impl)
    hT = hs[:, -1].clone()

    y = hs.to(x.dtype) * L.act_fn("gelu")(yb)
    out = torch.einsum("btr,rd->btd", y, p["w_out"])

    new_cache = None
    if mode == "decode":
        cache["conv"].copy_(win[:, 1:])
        cache["h"].copy_(hT)
        new_cache = {"conv": cache["conv"], "h": cache["h"],
                     "len": cache["len"] + 1}
    elif mode == "prefill":
        new_cache = {"conv": conv_state(xb, cfg.conv_width), "h": hT,
                     "len": torch.full((B,), T, dtype=torch.int32,
                                       device=x.device)}
    return out, new_cache


def _residual_pair_defs(cfg, mixer: str):
    d = {"ln1": L.norm_defs(cfg), "ln2": L.norm_defs(cfg),
         "mlp": L.mlp_defs(cfg)}
    d["mix"] = rglru_defs(cfg) if mixer == "rec" else L.attention_defs(cfg)
    return d


def _pair_apply(p, cfg, x, positions, mixer, mode, cache, impl="auto"):
    h = L.apply_norm(p["ln1"], x)
    if mixer == "rec":
        a, new_cache = rglru_apply(p["mix"], cfg, h, mode=mode, cache=cache,
                                   impl=impl)
    else:   # local attention: attention_apply reads cfg.window
        a, new_cache = L.attention_apply(p["mix"], cfg, h, positions,
                                         mode=mode, cache=cache, impl=impl)
    x = x + a
    h = L.apply_norm(p["ln2"], x)
    return x + L.mlp_apply(p["mlp"], cfg, h), new_cache


SUPER = (("rec0", "rec"), ("rec1", "rec"), ("attn", "attn"))


def _super_apply(lp, cfg, x, positions, mode, lc, impl):
    """One super-block [rec, rec, attn] -> (x, {name: new cache})."""
    nc = {}
    for name, mixer in SUPER:
        x, nc[name] = _pair_apply(lp[name], cfg, x, positions, mixer, mode,
                                  lc[name] if lc else None, impl)
    return x, nc


def _superblock_defs(cfg):
    return {name: _residual_pair_defs(cfg, mixer) for name, mixer in SUPER}


def hybrid_counts(cfg):
    n_super = cfg.num_layers // 3
    n_tail = cfg.num_layers - 3 * n_super  # leftover rec layers (0..2)
    return n_super, n_tail


def hybrid_lm_defs(cfg):
    n_super, n_tail = hybrid_counts(cfg)
    defs = {
        "embed": L.embed_defs(cfg),
        "super": stack_defs(_superblock_defs(cfg), n_super),
        "final_norm": L.norm_defs(cfg),
    }
    for i in range(n_tail):
        defs[f"tail{i}"] = _residual_pair_defs(cfg, "rec")
    return defs


def _rec_cache_defs(cfg, batch):
    return {
        "conv": pdef((batch, cfg.conv_width - 1, cfg.lru_width),
                     ("batch", None, "lru_width"), init="zeros"),
        "h": pdef((batch, cfg.lru_width), ("batch", "lru_width"),
                  dtype=torch.float32, init="zeros"),
        "len": pdef((batch,), ("batch",), dtype=torch.int32, init="zeros"),
    }


def hybrid_cache_defs(cfg, batch: int, seq_len: int):
    n_super, n_tail = hybrid_counts(cfg)
    per_super = {
        "rec0": _rec_cache_defs(cfg, batch),
        "rec1": _rec_cache_defs(cfg, batch),
        "attn": kvcache.attention_cache_defs(cfg, batch, seq_len),
    }
    defs = {"super": stack_defs(per_super, n_super)}
    for i in range(n_tail):
        defs[f"tail{i}"] = _rec_cache_defs(cfg, batch)
    return defs


def hybrid_lm_apply(params, cfg, batch_inputs, *, mode="train", cache=None,
                    impl="auto"):
    if mode not in ("train", "prefill", "decode"):
        raise NotImplementedError(f"mode {mode!r}")
    x = L.embed_apply(params["embed"], batch_inputs["tokens"])
    B, T = x.shape[0], x.shape[1]
    n_super, n_tail = hybrid_counts(cfg)

    if mode == "decode":
        positions = batch_inputs.get("positions")
        if positions is None:
            positions = cache["super"]["rec0"]["len"][0].reshape(B, 1)
    else:
        positions = torch.arange(T, dtype=torch.int32,
                                 device=x.device)[None].expand(B, T)

    super_caches = []
    for i in range(n_super):
        lp = layer_params(params["super"], i)
        lc = tree_map(lambda a: a[i], cache["super"]) \
            if mode == "decode" else None
        x, nc = L.remat(cfg, _super_apply, lp, cfg, x, positions, mode, lc,
                        impl, x=x, lp=lp)
        super_caches.append(nc)

    new_cache = None
    if mode == "prefill":
        new_cache = {"super": tree_map(lambda *ls: torch.stack(ls),
                                       *super_caches)}
    elif mode == "decode":
        # conv windows, states and K/V rows were written in place into the
        # stacked tensors; only the lengths are new
        new_cache = {"super": {
            name: {**cache["super"][name], "len": torch.stack(
                [nc[name]["len"] for nc in super_caches])}
            for name, _ in SUPER}}
    for i in range(n_tail):
        tc = cache[f"tail{i}"] if mode == "decode" else None
        x, nc = _pair_apply(params[f"tail{i}"], cfg, x, positions, "rec",
                            mode, tc, impl)
        if mode != "train":
            new_cache[f"tail{i}"] = nc

    if mode == "prefill":
        x = x[:, -1:]  # serving needs only the last position's logits
    x = L.apply_norm(params["final_norm"], x)
    logits = L.unembed_apply(params["embed"], x)
    if mode == "train":
        return logits, 0.0
    return logits, new_cache

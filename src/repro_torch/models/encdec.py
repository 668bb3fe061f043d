"""Encoder-decoder transformer backbone (seamless-m4t-large-v2), port of
`repro.models.encdec`, 3 modes:

  train   -- frames and tokens, full sequence, returns (logits, 0.0)
  prefill -- frames and tokens, returns (last-position logits, cache)
  decode  -- one token a row with the cache, returns (logits, cache)

The speech frontend is a STUB, as in the reference: the batch carries
precomputed frame embeddings `frames` (B, enc_len, d_model), cast to
bf16.  The encoder is a non-causal transformer with RoPE in its self
attention; the decoder a causal one with cross attention over the
encoder's output.  Decode uses a self KV cache (models/cache.py's
convention) and a static cross K/V cache made at prefill: the K/V the
prefill's cross attention used (the reference computes that einsum a
second time for the cache; the values are equal).

Layer params and caches stay stacked (L, ...), as in
models/transformer.py; the port loops over the layers in Python, and
with `cfg.remat` a call that carries a gradient checkpoints each encoder
and decoder layer (`layers.remat`), as the reference does.  Decode
writes each layer's new self K/V rows into the stacked cache in place;
the cross cache is read only.
"""
from __future__ import annotations

import torch

from repro_torch.models import cache as kvcache
from repro_torch.models import layers as L
from repro_torch.models.param import layer_params, pdef, stack_defs
from repro_torch.tree import tree_map

ENC_LEN_CAP = 4096  # frontend frames occupying the encoder


def enc_len_for(seq_len: int) -> int:
    return min(ENC_LEN_CAP, seq_len)


def _enc_block_defs(cfg):
    return {
        "ln1": L.norm_defs(cfg),
        "attn": L.attention_defs(cfg),
        "ln2": L.norm_defs(cfg),
        "mlp": L.mlp_defs(cfg),
    }


def _dec_block_defs(cfg):
    return {
        "ln1": L.norm_defs(cfg),
        "self_attn": L.attention_defs(cfg),
        "ln_x": L.norm_defs(cfg),
        "cross_attn": L.attention_defs(cfg),
        "ln2": L.norm_defs(cfg),
        "mlp": L.mlp_defs(cfg),
    }


def encdec_defs(cfg):
    return {
        "embed": L.embed_defs(cfg),
        "enc_layers": stack_defs(_enc_block_defs(cfg), cfg.enc_layers),
        "enc_norm": L.norm_defs(cfg),
        "dec_layers": stack_defs(_dec_block_defs(cfg), cfg.num_layers),
        "final_norm": L.norm_defs(cfg),
    }


def _positions(B: int, T: int, device):
    return torch.arange(T, dtype=torch.int32, device=device)[None].expand(B, T)


def encode(params, cfg, frames, impl="auto"):
    """frames: (B, Te, d) stub embeddings -> (B, Te, d) encoder states."""
    x = frames
    positions = _positions(x.shape[0], x.shape[1], x.device)
    for i in range(cfg.enc_layers):
        lp = layer_params(params["enc_layers"], i)
        x = L.remat(cfg, _enc_block, lp, cfg, x, positions, impl, x=x, lp=lp)
    return L.apply_norm(params["enc_norm"], x)


def _enc_block(lp, cfg, x, positions, impl="auto"):
    h = L.apply_norm(lp["ln1"], x)
    a, _ = L.attention_apply(lp["attn"], cfg, h, positions, mode="train",
                             causal=False, impl=impl)
    x = x + a
    h = L.apply_norm(lp["ln2"], x)
    return x + L.mlp_apply(lp["mlp"], cfg, h)


def _dec_block(lp, cfg, x, positions, enc_out, mode, cache, impl="auto"):
    h = L.apply_norm(lp["ln1"], x)
    a, self_cache = L.attention_apply(
        lp["self_attn"], cfg, h, positions, mode=mode,
        cache=cache["self"] if cache else None, impl=impl)
    x = x + a
    h = L.apply_norm(lp["ln_x"], x)
    if mode == "decode":
        a, cross_cache = L.attention_apply(
            lp["cross_attn"], cfg, h, positions, mode="decode",
            cache=cache["cross"], is_cross=True)
    else:
        # prefill returns the static cross K/V cache with the attention
        a, cross_cache = L.attention_apply(
            lp["cross_attn"], cfg, h, positions, mode=mode,
            kv_source=enc_out, impl=impl)
    x = x + a
    h = L.apply_norm(lp["ln2"], x)
    x = x + L.mlp_apply(lp["mlp"], cfg, h)
    return x, {"self": self_cache, "cross": cross_cache}


def encdec_cache_defs(cfg, batch: int, seq_len: int):
    el = enc_len_for(seq_len)
    kv = ((batch, el, cfg.num_kv_heads, cfg.head_dim),
          ("batch", None, "kv_heads", "kv_head_dim"))
    per_layer = {
        "self": kvcache.attention_cache_defs(cfg, batch, seq_len),
        "cross": {
            "k": pdef(*kv, init="zeros"),
            "v": pdef(*kv, init="zeros"),
            "len": pdef((batch,), ("batch",), dtype=torch.int32,
                        init="zeros"),
        },
    }
    return stack_defs(per_layer, cfg.num_layers)


def encdec_apply(params, cfg, batch_inputs, *, mode="train", cache=None,
                 impl="auto"):
    """train/prefill: batch_inputs = {frames, tokens}; decode: {tokens
    (B, 1)[, positions]} and the cache (the encoder already folded into
    the cross K/V)."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    enc_out = None
    if mode != "decode":
        enc_out = encode(params, cfg,
                         batch_inputs["frames"].to(torch.bfloat16), impl)

    x = L.embed_apply(params["embed"], batch_inputs["tokens"])
    B, T = x.shape[0], x.shape[1]
    if mode == "decode":
        positions = batch_inputs.get("positions")
        if positions is None:
            positions = cache["self"]["len"][0].reshape(B, 1)
    else:
        positions = _positions(B, T, x.device)

    new_caches = []
    for i in range(cfg.num_layers):
        lp = layer_params(params["dec_layers"], i)
        lc = tree_map(lambda a: a[i], cache) if mode == "decode" else None
        x, nc = L.remat(cfg, _dec_block, lp, cfg, x, positions, enc_out,
                        mode, lc, impl, x=x, lp=lp)
        if mode == "prefill":
            new_caches.append(nc)
        elif mode == "decode":
            new_caches.append(nc["self"]["len"])

    if mode == "prefill":
        x = x[:, -1:]  # serving needs only the last position's logits
    x = L.apply_norm(params["final_norm"], x)
    logits = L.unembed_apply(params["embed"], x)
    if mode == "train":
        return logits, 0.0
    if mode == "prefill":
        return logits, tree_map(lambda *ls: torch.stack(ls), *new_caches)
    # the self K/V rows were written in place into the stacked tensors;
    # only the lengths are new, and the cross cache is read only
    return logits, {"self": {**cache["self"], "len": torch.stack(new_caches)},
                    "cross": cache["cross"]}

"""Decoder-only LM (dense and MoE blocks, the VLM stub), port of
`repro.models.transformer`, 4 modes:

  train         -- full-sequence forward, returns (logits, aux: the MoE
                   load-balance loss summed over layers, 0.0 for dense)
  prefill       -- full-sequence forward, returns (last-position logits,
                   cache)
  decode        -- single-token step with a contiguous KV cache or a
                   paged one ({kp, vp, bt, len}), returns (logits, cache)
  chunk_prefill -- a chunk of a prompt at the batch's `positions` into a
                   contiguous spec'd cache or the paged pool (with the
                   batch's `block_tables`), returns (logits at the batch's
                   `last_index`, cache)

Layer params stay stacked (L, ...) as the reference's `lax.scan` takes
them (so `from_reference` moves them leaf for leaf, and a full-width
model is never held twice); the port loops over L in Python and indexes
the stack (`param.layer_params`; a train step passes the stack as
per-layer slices, `param.LayerSlices`).  With `cfg.remat`, a call that
carries a gradient checkpoints each layer (`layers.remat`), where the
reference wraps its scan body in `jax.checkpoint`.  Caches are stacked
(L, ...) too; decode and chunk_prefill write each layer's new K/V rows
into them in place.  Every mode runs
each layer's MoE block on the rows it is given (padding rows of a
bucketed chunk and idle decode slots included, as in the reference).

The VLM stub frontend (`frontend="vision_stub"`): a batch may carry
precomputed `patch_embeds` (B, P, d_model), which replace the first P
token embeddings in any mode that is given them (decode carries none).
A sequence shorter than P is refused, where the reference would lengthen
it to P.
"""
from __future__ import annotations

import torch

from repro_torch.models import cache as kvcache
from repro_torch.models import layers as L
from repro_torch.models.param import layer_params, stack_defs
from repro_torch.tree import tree_map


def block_defs(cfg):
    d = {
        "ln1": L.norm_defs(cfg),
        "attn": L.attention_defs(cfg),
        "ln2": L.norm_defs(cfg),
    }
    if cfg.family == "moe" or (cfg.num_experts and cfg.family != "dense"):
        d["moe"] = L.moe_defs(cfg)
    else:
        d["mlp"] = L.mlp_defs(cfg)
    return d


def lm_defs(cfg):
    return {
        "embed": L.embed_defs(cfg),
        "layers": stack_defs(block_defs(cfg), cfg.num_layers),
        "final_norm": L.norm_defs(cfg),
    }


def cache_defs(cfg, batch: int, seq_len: int, spec=None):
    """Decode-cache defs under a CacheSpec (default: cfg.cache_spec).
    The convention itself lives in models/cache.py."""
    per_layer = kvcache.attention_cache_defs(cfg, batch, seq_len, spec)
    return stack_defs(per_layer, cfg.num_layers)


def paged_cache_defs(cfg, batch: int, num_blocks: int, block_size: int,
                     max_blocks_per_seq: int):
    """Block-table paged decode cache (core/paging.py): one KV block pool
    per layer, shared by all slots, plus per-slot tables and lengths."""
    per_layer = kvcache.paged_attention_cache_defs(
        cfg, batch, num_blocks, block_size, max_blocks_per_seq)
    return stack_defs(per_layer, cfg.num_layers)


def _block_apply(p, cfg, x, positions, mode, cache, impl="auto"):
    h = L.apply_norm(p["ln1"], x)
    a, new_cache = L.attention_apply(p["attn"], cfg, h, positions,
                                     mode=mode, cache=cache, impl=impl)
    x = x + a
    h = L.apply_norm(p["ln2"], x)
    if "moe" in p:
        m, aux = L.moe_apply(p["moe"], cfg, h)
    else:
        m, aux = L.mlp_apply(p["mlp"], cfg, h), 0.0
    return x + m, new_cache, aux


def _embed_inputs(params, cfg, batch_inputs):
    """Tokens, with the stub modality embeddings occupying a prefix."""
    x = L.embed_apply(params["embed"], batch_inputs["tokens"])
    pe = batch_inputs.get("patch_embeds")
    if cfg.frontend == "vision_stub" and pe is not None:
        P = pe.shape[1]
        if x.shape[1] < P:
            raise ValueError(f"{cfg.name}: {x.shape[1]} positions cannot "
                             f"hold the {P} patch embeddings of the prefix")
        x = torch.cat([pe.to(x.dtype), x[:, P:]], dim=1)
    return x


def lm_apply(params, cfg, batch_inputs, *, mode="train", cache=None,
             impl="auto"):
    if mode not in ("train", "prefill", "decode", "chunk_prefill"):
        raise ValueError(f"unknown mode {mode!r}")
    x = _embed_inputs(params, cfg, batch_inputs)
    B, T = x.shape[0], x.shape[1]
    if mode == "decode":
        # cache["len"] is stacked (L, B); all layers share the same length
        positions = batch_inputs.get("positions")
        if positions is None:
            positions = cache["len"][0].reshape(B, 1)
    elif mode == "chunk_prefill":
        # absolute positions of this chunk's tokens; -1 marks padding rows
        # (bucketed tail chunks) whose cache writes and logits are dropped
        positions = batch_inputs["positions"]
    else:
        positions = torch.arange(T, dtype=torch.int32,
                                 device=x.device)[None].expand(B, T)
    bt = batch_inputs.get("block_tables")   # (B, nbmax): paged chunks only

    new_caches, aux = [], 0.0
    for i in range(cfg.num_layers):
        lp = layer_params(params["layers"], i)
        lc = None
        if mode in ("decode", "chunk_prefill"):
            lc = tree_map(lambda a: a[i], cache)
            if bt is not None:
                lc["bt"] = bt
        x, new_cache, a = L.remat(cfg, _block_apply, lp, cfg, x, positions,
                                  mode, lc, impl, x=x, lp=lp)
        aux = aux + a
        if mode == "prefill":
            new_caches.append(new_cache)
        elif mode != "train" and "len" in new_cache:
            new_caches.append(new_cache["len"])

    if mode == "prefill":
        x = x[:, -1:]  # serving needs only the last position's logits
    elif mode == "chunk_prefill":
        # only the last VALID position's logits matter (tail chunks are
        # padded to a bucket length)
        li = batch_inputs["last_index"].reshape(B).long()
        x = x[torch.arange(B, device=x.device), li][:, None]
    x = L.apply_norm(params["final_norm"], x)
    logits = L.unembed_apply(params["embed"], x)
    if mode == "train":
        return logits, aux
    if mode == "prefill":
        return logits, tree_map(lambda *ls: torch.stack(ls), *new_caches)
    # k/v (and scales, or the paged pool) were written in place into the
    # stacked tensors; a paged chunk carries no lengths
    if new_caches:
        return logits, {**cache, "len": torch.stack(new_caches)}
    return logits, cache

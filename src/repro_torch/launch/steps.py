"""Step factories, port of `repro.launch.steps`: the island exchange
(`make_fl_aggregate`) and the serve steps (`make_prefill_step`,
`make_chunk_prefill_step`, `make_decode_step`).  The train steps come with
the training slice."""
from __future__ import annotations

from functools import partial

import torch

from repro_torch.core import federated


def make_fl_aggregate(compress=False, *, k_frac: float = 0.05,
                      impl: str = "auto"):
    """(stacked_params, mixing (P,P)) -> mixed stacked_params.  The paper's
    whole weight-exchange round.

    compress: False/"none" -> raw exchange (storage dtype on the wire);
    True/"q8", "topk", "q8_topk" (dashes accepted) -> the compressed delta
    exchange, signature (stacked, base, mixing), whose quant8 calls take
    `impl`."""
    mode = {False: "none", None: "none", True: "q8"}.get(compress, compress)
    mode = mode.replace("-", "_")
    if mode == "none":
        return federated.fl_aggregate
    return partial(federated.fl_aggregate_compressed, mode=mode,
                   k_frac=k_frac, impl=impl)


def make_prefill_step(model):
    """(params, batch) -> (greedy next token (B,), decode cache)."""
    @torch.no_grad()
    def prefill_step(params, batch):
        logits, cache = model.apply(params, batch, mode="prefill")
        next_tok = torch.argmax(logits[:, -1].float(), dim=-1)
        return next_tok, cache
    return prefill_step


def make_chunk_prefill_step(model):
    """One chunk of chunked prefill: (params, batch, cache) -> (greedy
    next token (B,), cache).  `batch` carries the chunk's tokens, their
    absolute positions and last_index (the last valid row of a padded
    tail chunk); for the paged pool also block_tables.  `cache` is a
    contiguous spec'd cache (models/cache.py) or the pool {kp, vp},
    updated in place and consumed, as the JAX step donates it."""
    @torch.no_grad()
    def chunk_prefill_step(params, batch, cache):
        logits, cache = model.apply(params, batch, mode="chunk_prefill",
                                    cache=cache)
        next_tok = torch.argmax(logits[:, -1].float(), dim=-1)
        return next_tok, cache
    return chunk_prefill_step


def make_decode_step(model):
    """(params, batch, cache) -> (greedy next token (B,), cache).  The
    cache is updated in place and consumed, as the JAX loop donates it."""
    @torch.no_grad()
    def decode_step(params, batch, cache):
        logits, cache = model.apply(params, batch, mode="decode", cache=cache)
        next_tok = torch.argmax(logits[:, -1].float(), dim=-1)
        return next_tok, cache
    return decode_step

"""The benchmark's generator of training rows, driven by the parameters of
a traffic file and the run's seed.

* `token_stream` / `lm_rows`: a Zipf token stream with a weak bigram
  structure (a copy of `repro_torch.data.synthetic.make_token_stream`)
  and the rows a train step of the program takes from it at a step (the
  feed rule of `launch/train.py`'s `batch_token_stream`, copied, so the
  reference derives the same rows itself).
"""
from __future__ import annotations

import numpy as np


def _rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed), *stream])


def token_stream(vocab: int, n_tokens: int, seed: int, island: int, *,
                 zipf_a: float = 1.2, repeat_p: float = 0.3) -> np.ndarray:
    rng = _rng(seed, 1, island)
    base = rng.zipf(zipf_a, size=n_tokens).astype(np.int64)
    toks = (base - 1) % vocab
    rep = rng.random(n_tokens) < repeat_p
    toks[1:][rep[1:]] = (toks[:-1][rep[1:]] + 1) % vocab
    return toks.astype(np.int32)


def lm_rows(stream: np.ndarray, batch: int, seq: int, step: int):
    """(tokens, labels), each (batch, seq), of step `step` (0-based)."""
    need = batch * (seq + 1)
    off = (step * need) % max(len(stream) - need - 1, 1)
    window = stream[off:off + need]
    x = window[:batch * seq].reshape(batch, seq)
    y = window[1:batch * seq + 1].reshape(batch, seq)
    return x, y

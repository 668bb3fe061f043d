"""Deterministic synthetic datasets (offline stand-ins; see DESIGN.md SS9).

synMNIST / synCIFAR: 10-class Gaussian-prototype images.  Each class has a
fixed random prototype; samples are prototype + noise (+ per-sample random
shift), so the task is learnable but not trivial -- small CNN/MLP reach
>90% (synMNIST) / ~50-70% (synCIFAR, higher noise), mirroring the paper's
MNIST/CIFAR accuracy regimes.

Token streams: Zipf-distributed token sequences for LM examples.
"""
from __future__ import annotations

import zlib

import numpy as np


def make_classification_set(kind: str, n: int, *, seed: int = 0):
    """kind: 'synmnist' (28x28x1) | 'syncifar' (32x32x3).
    Returns (images float32 [0,1], labels int32).

    Class prototypes are a FIXED function of `kind` (crc32-seeded, stable
    across processes): every split of the same kind shares one class
    structure, while `seed` only drives sampling/noise -- so a train split
    generalises to a test split."""
    if kind == "synmnist":
        hw, c, noise = 28, 1, 0.35
    elif kind == "syncifar":
        hw, c, noise = 32, 3, 2.0  # much noisier: ~50-60% achievable, the
        # paper's CIFAR regime (its Fig.16 cites ~50% theoretical accuracy)
    else:
        raise ValueError(kind)
    proto_rng = np.random.default_rng(zlib.crc32(kind.encode()))
    protos = proto_rng.normal(0.5, 0.35, size=(10, hw, hw, c))
    rng = np.random.default_rng(zlib.crc32(f"{kind}-{seed}".encode()))
    labels = rng.integers(0, 10, size=n).astype(np.int32)
    imgs = protos[labels]
    # per-sample jitter: small spatial roll + gaussian noise
    rolls = rng.integers(-2, 3, size=(n, 2))
    out = np.empty((n, hw, hw, c), np.float32)
    for shift in np.unique(rolls, axis=0):
        m = (rolls == shift).all(axis=1)
        out[m] = np.roll(imgs[m], tuple(shift), axis=(1, 2))
    out += rng.normal(0.0, noise, size=out.shape)
    return np.clip(out, 0.0, 1.0).astype(np.float32), labels


def make_token_stream(vocab: int, n_tokens: int, *, seed: int = 0,
                      zipf_a: float = 1.2) -> np.ndarray:
    """Zipf token stream with a weak bigram structure (next ~ prev + noise),
    enough signal for an LM to show decreasing loss."""
    rng = np.random.default_rng(seed)
    base = rng.zipf(zipf_a, size=n_tokens).astype(np.int64)
    toks = (base - 1) % vocab
    # bigram coupling: with p=0.3 the next token repeats (prev+1) % vocab
    rep = rng.random(n_tokens) < 0.3
    toks[1:][rep[1:]] = (toks[:-1][rep[1:]] + 1) % vocab
    return toks.astype(np.int32)


def batch_token_stream(stream: np.ndarray, batch: int, seq_len: int,
                       step: int):
    """Slice deterministic (tokens, labels) LM batches from a stream."""
    need = batch * (seq_len + 1)
    off = (step * need) % max(len(stream) - need - 1, 1)
    window = stream[off: off + need]
    x = window[: batch * seq_len].reshape(batch, seq_len)
    y = window[1: batch * seq_len + 1].reshape(batch, seq_len)
    return x, y

"""The random streams of `jax.random`'s default generator, in numpy.

JAX draws with Threefry-2x32 (Salmon et al., SC'11), a counter-based
generator: every draw is a pure function of a 64-bit key and a counter, so
the stream can be computed anywhere.  This module computes it as JAX does
by default (the "partitionable" counter layout) for the draws the FL path
makes: keys from a seed, `split`, `permutation` (batch orders) and
`normal` (parameter init).  A port run can then start from the JAX run's
params and walk its batch orders, and the two runs differ only in float
rounding.

Keys are (2,) uint32 arrays, like `jax.random.key_data(jax.random.key(s))`.
Bits, splits and permutations equal JAX's bit for bit; `normal` follows
XLA's float32 `erf_inv` and agrees with JAX to a few ulp (its `log1p` is
numpy's, not XLA's).
"""
from __future__ import annotations

import math

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray
                 ) -> tuple[np.ndarray, np.ndarray]:
    """The 20-round Threefry-2x32 block function over counter words
    (x0, x1) (uint32 arrays of one shape); all sums wrap mod 2**32."""
    k0, k1 = np.asarray(key, np.uint32)
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = np.asarray(x0, np.uint32) + ks[0]
    x1 = np.asarray(x1, np.uint32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def _counters(n: int) -> tuple[np.ndarray, np.ndarray]:
    """The (hi, lo) words of a 64-bit iota of length n."""
    idx = np.arange(n, dtype=np.uint64)
    return (idx >> np.uint64(32)).astype(np.uint32), idx.astype(np.uint32)


def key(seed: int) -> np.ndarray:
    """`jax.random.key(seed)`'s data."""
    seed = int(seed)
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], np.uint32)


def split(k: np.ndarray, num: int = 2) -> np.ndarray:
    """`jax.random.split(k, num)` -> (num, 2) keys."""
    b0, b1 = threefry2x32(k, *_counters(num))
    return np.stack([b0, b1], axis=-1)


def random_bits(k: np.ndarray, shape) -> np.ndarray:
    """32 random bits per element of `shape`, row-major counters."""
    shape = tuple(int(s) for s in shape)
    b0, b1 = threefry2x32(k, *_counters(math.prod(shape)))
    return (b0 ^ b1).reshape(shape)


def permutation(k: np.ndarray, n: int) -> np.ndarray:
    """`jax.random.permutation(k, n)`: rounds of sorting by random keys."""
    x = np.arange(n, dtype=np.int64)
    rounds = math.ceil(3 * math.log(max(1, n)) / math.log(2**32 - 1))
    for _ in range(rounds):
        k, sub = split(k)
        x = x[np.argsort(random_bits(sub, (n,)), kind="stable")]
    return x


# Giles' single-precision erfinv, with XLA's coefficients (ErfInv32).
_ERFINV_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                  -4.39150654e-06, 0.00021858087, -0.00125372503,
                  -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322,
                  -0.00367342844, 0.00573950773, -0.0076224613,
                  0.00943887047, 1.00167406, 2.83297682)


def _erfinv_f32(x: np.ndarray) -> np.ndarray:
    f32 = np.float32
    w = -np.log1p(-x * x)
    lt = w < f32(5.0)
    w = np.where(lt, w - f32(2.5), np.sqrt(w) - f32(3.0)).astype(f32)
    p = np.where(lt, f32(_ERFINV_W_LT_5[0]), f32(_ERFINV_W_GE_5[0]))
    for a, b in zip(_ERFINV_W_LT_5[1:], _ERFINV_W_GE_5[1:]):
        p = (np.where(lt, f32(a), f32(b)) + p * w).astype(f32)
    return np.where(np.abs(x) == f32(1), x * np.finfo(f32).max, p * x)


def normal(k: np.ndarray, shape) -> np.ndarray:
    """`jax.random.normal(k, shape, float32)`: sqrt(2)·erfinv(u) with u
    uniform on (-1, 1) built from the top 23 bits of each draw."""
    f32 = np.float32
    bits = random_bits(k, shape)
    u = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(f32) - f32(1)
    lo = np.nextafter(f32(-1), f32(0))
    u = np.maximum(lo, u * (f32(1) - lo) + lo)
    return (f32(np.sqrt(2)) * _erfinv_f32(u)).astype(f32)

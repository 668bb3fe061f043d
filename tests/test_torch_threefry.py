"""The port's numpy Threefry streams (repro_torch/threefry.py) against
`jax.random`: keys, splits, bits and permutations bit for bit; normal
draws to a few ulp (XLA's float32 log1p and fused multiply-adds differ
from numpy's in the last bits)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

from repro_torch import threefry

SEEDS = [0, 1, 7, 2**31 - 1]


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_and_splits_equal(seed):
    k = jax.random.key(seed)
    assert np.array_equal(np.asarray(jax.random.key_data(k)),
                          threefry.key(seed))
    for num in (1, 2, 5):
        assert np.array_equal(
            np.asarray(jax.random.key_data(jax.random.split(k, num))),
            threefry.split(threefry.key(seed), num))


@pytest.mark.parametrize("seed", SEEDS)
def test_bits_equal(seed):
    for shape in ((7,), (3, 3, 1, 16), (129, 10)):
        assert np.array_equal(
            np.asarray(jax.random.bits(jax.random.key(seed), shape,
                                       jnp.uint32)),
            threefry.random_bits(threefry.key(seed), shape))


@pytest.mark.parametrize("n", [1, 64, 100, 256, 1700])
def test_permutations_equal(n):
    """n = 1700 takes two sorting rounds (ceil(3 ln n / ln(2^32 - 1)))."""
    for seed in SEEDS:
        assert np.array_equal(
            np.asarray(jax.random.permutation(jax.random.key(seed), n)),
            threefry.permutation(threefry.key(seed), n))


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_within_a_few_ulp(seed):
    shape = (1568, 10)
    want = np.asarray(jax.random.normal(jax.random.key(seed), shape,
                                        jnp.float32))
    got = threefry.normal(threefry.key(seed), shape)
    assert got.dtype == np.float32 and got.shape == shape
    assert np.all(np.abs(got - want) <= 4 * np.spacing(np.abs(want)))

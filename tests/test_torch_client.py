"""The port's LocalTrainer (core/client.py) against the JAX package's, fed
the batch orders JAX draws: same params after local training, the cohort
equal to the per-member path, and the non-finite guard."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config
from repro.core import client as jclient
from repro.models import build_model as jax_build_model
from repro_torch import threefry
from repro_torch.configs import get_config
from repro_torch.core import client as tclient
from repro_torch.models import build_model
from repro_torch.models.param import from_reference, to_numpy
from repro_torch.tree import leaves

ARCH = "flight-cnn-mnist"


@pytest.fixture(scope="module")
def setup(synmnist):
    jm = jax_build_model(jax_get_config(ARCH))
    tm = build_model(get_config(ARCH))
    params = jm.init(jax.random.key(0))
    return (jclient.LocalTrainer(jm, lr=0.05, batch_size=32),
            tclient.LocalTrainer(tm, lr=0.05, batch_size=32), params)


def jax_orders(key, n, epochs):
    """The batch orders JAX's `_train_impl` draws from `key`."""
    return np.stack([np.asarray(jax.random.permutation(ek, n))
                     for ek in jax.random.split(key, epochs)])


def test_softmax_xent_and_accuracy_match(rng):
    logits = rng.normal(size=(9, 10)).astype(np.float32)
    labels = rng.integers(0, 10, 9).astype(np.int32)
    np.testing.assert_allclose(
        float(tclient.softmax_xent(torch.from_numpy(logits),
                                   torch.from_numpy(labels))),
        float(jclient.softmax_xent(jnp.asarray(logits), jnp.asarray(labels))),
        rtol=1e-6)
    assert float(tclient.accuracy(torch.from_numpy(logits),
                                  torch.from_numpy(labels))) == \
        float(jclient.accuracy(jnp.asarray(logits), jnp.asarray(labels)))


def test_batch_geometry_drops_the_tail():
    t = tclient.LocalTrainer(None, batch_size=32)
    assert t.geometry(100) == (32, 3)
    assert t.geometry(20) == (20, 1)
    assert t.geometry(64) == (32, 2)


def test_train_matches_jax_given_its_orders(setup, synmnist):
    """2 epochs of 3 batches (100 samples, bs 32: the 4-sample tail is
    dropped).  1e-4 absolute: the two frameworks' convolutions sum in
    different orders, and 6 SGD steps with momentum carry that through."""
    jt, tt, params = setup
    x, y = synmnist[0][:100], synmnist[1][:100]
    key = jax.random.key(7)
    want = jt.train(params, jnp.asarray(x), jnp.asarray(y), key, 2)
    got = tt.train(from_reference(params), torch.from_numpy(x),
                   torch.from_numpy(y), 2, order=jax_orders(key, 100, 2))
    for k in params:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-4)
        assert not np.allclose(np.asarray(want[k]), np.asarray(params[k]))


@pytest.mark.parametrize("n,epochs", [(100, 2), (256, 4), (0, 1), (64, 0)])
def test_draw_orders_are_the_reference_orders(n, epochs):
    for seed in (0, 7):
        got = tclient.draw_orders(threefry.key(seed), n, epochs)
        assert got.dtype == torch.int64 and got.shape == (epochs, n)
        want = jax_orders(jax.random.key(seed), n, epochs) \
            if n and epochs else np.zeros((epochs, n))
        assert np.array_equal(got.numpy(), want)


def test_train_rejects_a_short_order(setup, synmnist):
    _, tt, params = setup
    x, y = torch.from_numpy(synmnist[0][:64]), torch.from_numpy(synmnist[1][:64])
    with pytest.raises(ValueError):
        tt.train(from_reference(params), x, y, 2,
                 order=np.zeros((1, 64), np.int64))


def test_cohort_equals_per_member_path(setup, synmnist):
    _, tt, params = setup
    C, n = 3, 64
    x = torch.from_numpy(synmnist[0][:C * n]).reshape(C, n, 28, 28, 1)
    y = torch.from_numpy(synmnist[1][:C * n]).reshape(C, n)
    orders = torch.stack([tclient.draw_orders(k, n, 2)
                          for k in threefry.split(threefry.key(5), C)])
    p = from_reference(params)
    stacked, oks = tt.train_cohort_checked(p, x, y, orders, 2)
    assert oks.tolist() == [True] * C
    for i in range(C):
        one = tt.train(p, x[i], y[i], 2, order=orders[i])
        for k in p:
            torch.testing.assert_close(stacked[k][i], one[k], rtol=1e-5,
                                       atol=1e-5)


def test_finite_guard_returns_input_params(setup, synmnist):
    _, tt, params = setup
    p = from_reference(params)
    x = synmnist[0][:64].copy()
    y = torch.from_numpy(synmnist[1][:64])
    bad = x.copy()
    bad[3, 5, 5, 0] = np.nan
    new, ok = tt.train_checked(p, torch.from_numpy(bad), y, 1,
                               order=np.arange(64)[None])
    assert ok is False
    assert all(a is b for a, b in zip(leaves(new), leaves(p)))
    cx = torch.from_numpy(np.stack([x, bad]))
    cy = torch.stack([y, y])
    orders = torch.from_numpy(np.tile(np.arange(64), (2, 1, 1)))
    stacked, oks = tt.train_cohort_checked(p, cx, cy, orders, 1)
    assert oks.tolist() == [True, False]
    for k in p:
        assert torch.equal(stacked[k][1], p[k])
        assert torch.isfinite(stacked[k][0]).all()
        assert not torch.equal(stacked[k][0], p[k])


def test_sim_worker_trains_on_params_device(setup, synmnist):
    _, tt, params = setup
    w = tclient.SimWorker(0, synmnist[0][:64], synmnist[1][:64], tt, None)
    p = from_reference(params)
    new = w.local_train(p, tclient.draw_orders(threefry.key(1), 64, 1), 1)
    assert not w.diverged and new["fc_w"].device == p["fc_w"].device
    empty = tclient.SimWorker(1, synmnist[0][:0], synmnist[1][:0], tt, None)
    assert empty.local_train(p, tclient.draw_orders(threefry.key(1), 0, 1),
                             1) is p
    # the evaluation agrees with JAX's on the same params
    jt, _, _ = setup
    np.testing.assert_allclose(
        tt.evaluate(new, torch.from_numpy(synmnist[0][:256]),
                    torch.from_numpy(synmnist[1][:256])),
        jt.evaluate({k: jnp.asarray(v) for k, v in to_numpy(new).items()},
                    jnp.asarray(synmnist[0][:256]),
                    jnp.asarray(synmnist[1][:256])), atol=1 / 256)

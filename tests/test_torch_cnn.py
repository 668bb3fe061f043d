"""The port's CNN / MLP classifiers (models/cnn.py) on params transferred
from the JAX package: logits and loss gradients agree to 1e-5 in fp32."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config
from repro.core.client import softmax_xent as jax_xent
from repro.models import build_model as jax_build_model
from repro.models.config import ModelConfig as JaxModelConfig
from repro_torch import threefry
from repro_torch.configs import get_config
from repro_torch.core.client import softmax_xent
from repro_torch.models import build_model
from repro_torch.models.config import ModelConfig
from repro_torch.models.param import from_reference, to_numpy

MLP = dict(name="tiny-mlp", family="cnn", num_layers=0, d_model=48,
           img_hw=28, img_c=1, n_classes=10, remat=False)
ARCHS = ["flight-cnn-mnist", "flight-cnn-cifar", "mlp"]


def _pair(arch, seed=0):
    if arch == "mlp":
        jm, tm = jax_build_model(JaxModelConfig(**MLP)), \
            build_model(ModelConfig(**MLP))
    else:
        jm, tm = jax_build_model(jax_get_config(arch)), \
            build_model(get_config(arch))
    params = jm.init(jax.random.key(seed))
    cfg = tm.cfg
    x = np.random.default_rng(seed).uniform(
        0, 1, size=(6, cfg.img_hw, cfg.img_hw, cfg.img_c)).astype(np.float32)
    y = np.random.default_rng(seed + 1).integers(0, 10, 6).astype(np.int32)
    return jm, tm, params, x, y


@pytest.mark.parametrize("arch", ARCHS)
def test_defs_match_reference(arch):
    jm, tm, params, _, _ = _pair(arch)
    jd, td = jm.param_defs(), tm.param_defs()
    assert sorted(jd) == sorted(td)
    for k in jd:
        assert jd[k].shape == td[k].shape and jd[k].init == td[k].init
        assert jd[k].fan_in_axes == td[k].fan_in_axes
    assert tm.n_params == jm.n_params
    # the same seed gives the reference's params: Threefry bits are equal,
    # the float32 erfinv of the normal draw agrees to a few ulp
    p = tm.init(threefry.key(0), device="cpu")
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {k: tuple(np.shape(v)) for k, v in params.items()}
    for k, v in params.items():
        np.testing.assert_allclose(p[k].numpy(), np.asarray(v), rtol=1e-6,
                                   atol=0)


def test_flight_cnn_mnist_has_20490_params():
    assert build_model(get_config("flight-cnn-mnist")).n_params == 20_490


@pytest.mark.parametrize("arch", ARCHS)
def test_from_reference_round_trip(arch):
    _, _, params, _, _ = _pair(arch)
    back = to_numpy(from_reference(params))
    assert sorted(back) == sorted(params)
    for k, v in params.items():
        assert back[k].dtype == np.asarray(v).dtype
        assert np.array_equal(back[k], np.asarray(v))


@pytest.mark.parametrize("arch", ARCHS)
def test_logits_match_reference(arch):
    jm, tm, params, x, _ = _pair(arch)
    want, _ = jm.apply(params, {"images": jnp.asarray(x)})
    got, aux = tm.apply(from_reference(params), {"images": torch.from_numpy(x)})
    assert aux == 0.0 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_gradients_match_reference(arch):
    jm, tm, params, x, y = _pair(arch, seed=3)

    def jloss(p):
        return jax_xent(jm.apply(p, {"images": jnp.asarray(x)})[0],
                        jnp.asarray(y))

    def tloss(p):
        return softmax_xent(tm.apply(p, {"images": torch.from_numpy(x)})[0],
                            torch.from_numpy(y))

    jl, jg = jax.value_and_grad(jloss)(params)
    tp = from_reference(params)
    tg = torch.func.grad(tloss)(tp)
    np.testing.assert_allclose(float(tloss(tp)), float(jl), rtol=1e-5)
    for k in params:
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]),
                                   rtol=1e-5, atol=1e-5)


def test_unported_family_raises():
    """Every family of the reference is ported; an unknown one raises."""
    cfg = dataclasses.replace(get_config("flight-cnn-mnist"),
                              family="no-such-family")
    with pytest.raises(ValueError, match="unknown family"):
        build_model(cfg)


def test_init_defaults_to_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    model = build_model(get_config("flight-cnn-mnist"))
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init(threefry.key(0))

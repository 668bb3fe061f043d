"""The port's dense LM (models/transformer.py, model_factory, configs) on
the four dense smoke configs against the JAX package, params carried
across with `from_reference`: train-mode logits, prefill logits and cache,
and three teacher-forced decode steps, at 2e-2 (the reference's own decode
tolerance, tests/test_decode_consistency.py); then the port's
prefill-then-decode against its own teacher forcing.

The port's attention keeps the probabilities in fp32 through PV (the
kernel's contract, as the Pallas kernel does) where the reference's
`attention_full` casts them to bf16 first; with that one cast the port's
attention output is bit-identical to JAX's.  So bf16 values differ by an
ulp here and there, and logits reach |4|, where one bf16 ulp (0.031) is
more than an absolute 2e-2.  Logits and caches are therefore held as
tests/test_cache_spec.py holds them: max |diff| / max |ref| <= 2e-2 and
rms |diff| <= 1e-2.

  granite-20b  MQA, plain tanh-GELU MLP
  chatglm3-6b  GQA, qkv bias, rope_fraction 0.5, gated SiLU
  qwen1.5-4b   MHA with bias, D = 12
  minitron-8b  LayerNorm, squared ReLU
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke
from repro.models import build_model as jax_build
from repro_torch import threefry
from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.models import build_model
from repro_torch.models.param import (from_reference, init_params_on_device,
                                      pdef)
from repro_torch.tree import leaves

DENSE = ["granite-20b", "chatglm3-6b", "qwen1.5-4b", "minitron-8b"]
TOL = 2e-2


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _close(got, want, tol=TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    d = np.abs(got - want)
    assert d.max() <= tol * np.abs(want).max(), \
        f"scale-relative max {d.max() / np.abs(want).max():.4f}"
    assert np.sqrt((d ** 2).mean()) <= tol / 2, \
        f"rms {np.sqrt((d ** 2).mean()):.4f}"


def _pair(arch, seed=3, spec="auto"):
    jm = jax_build(dataclasses.replace(jax_smoke(arch), cache_spec=spec))
    tm = build_model(dataclasses.replace(get_smoke_config(arch),
                                         cache_spec=spec))
    jp = jm.init(jax.random.key(seed))
    return jm, tm, jp, from_reference(jp)


def _tokens(cfg, B, T, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, T)).astype(np.int32)


@pytest.mark.parametrize("arch", DENSE)
def test_configs_and_defs_match_jax(arch):
    assert arch in list_archs()
    for tget, jget in ((get_config, jax_get_config),
                       (get_smoke_config, jax_smoke)):
        assert dataclasses.asdict(tget(arch)) == dataclasses.asdict(jget(arch))
    for cfg_fn in (get_config, get_smoke_config):
        tm, jm = build_model(cfg_fn(arch)), jax_build(
            (jax_get_config if cfg_fn is get_config else jax_smoke)(arch))
        assert tm.n_params == jm.n_params
        for tdefs, jdefs in ((tm.param_defs(), jm.param_defs()),
                             (tm.cache_defs(2, 40), jm.cache_defs(2, 40))):
            tl = leaves(tdefs)
            jl = jax.tree.leaves(jdefs,
                                 is_leaf=lambda d: hasattr(d, "fan_in_axes"))
            assert [(d.shape, str(d.dtype).split(".")[-1], d.init,
                     d.fan_in_axes) for d in tl] == \
                [(d.shape, str(jnp.dtype(d.dtype)), d.init, d.fan_in_axes)
                 for d in jl]
    if arch == "granite-20b":     # 52 x 6144, MQA, 20.3 B params, bf16
        assert round(build_model(get_config(arch)).n_params / 1e9, 2) == 20.32


@pytest.mark.parametrize("arch", DENSE)
def test_train_logits_match_jax(arch):
    jm, tm, jp, tp = _pair(arch)
    toks = _tokens(jm.cfg, 2, 19)
    jl, jaux = jm.apply(jp, {"tokens": jnp.asarray(toks)}, mode="train")
    tl, taux = tm.apply(tp, {"tokens": torch.as_tensor(toks)}, mode="train")
    assert tl.dtype == torch.bfloat16 and tuple(tl.shape) == jl.shape
    assert taux == 0.0 and float(jaux) == 0.0
    _close(tl, jl)


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_match_jax(arch):
    """Prefill logits and cache, then three teacher-forced decode steps
    (each step's logits and the caches after it)."""
    jm, tm, jp, tp = _pair(arch, seed=4)
    B, T = 2, 16
    toks = _tokens(jm.cfg, B, T + 3, seed=1)
    jl, jc = jm.apply(jp, {"tokens": jnp.asarray(toks[:, :T])},
                      mode="prefill")
    tl, tc = tm.apply(tp, {"tokens": torch.as_tensor(toks[:, :T])},
                      mode="prefill")
    assert tl.shape == (B, 1, jm.cfg.vocab_size)
    _close(tl, jl)
    assert tc.keys() == jc.keys()
    for key in jc:
        assert tuple(tc[key].shape) == jc[key].shape
        _close(tc[key], jc[key])
    for i in range(3):
        b = {"tokens": toks[:, T + i:T + i + 1],
             "positions": np.full((B, 1), T + i, np.int32)}
        jl, jc = jm.apply(jp, {k: jnp.asarray(v) for k, v in b.items()},
                          mode="decode", cache=jc)
        tl, tc = tm.apply(tp, {k: torch.as_tensor(v) for k, v in b.items()},
                          mode="decode", cache=tc)
        _close(tl, jl)
        np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))
        _close(tc["k"], jc["k"])
        _close(tc["v"], jc["v"])


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_then_decode_matches_teacher_forcing(arch):
    """The port against itself, as tests/test_decode_consistency.py holds
    the reference: prefill T tokens, decode token T, compare with the
    train-mode logits at position T.  Without `positions`, decode reads
    them from the cache's lengths."""
    _, tm, _, tp = _pair(arch, seed=1)
    B, T = 2, 16
    toks = torch.as_tensor(_tokens(tm.cfg, B, T + 1, seed=2))
    ref, _ = tm.apply(tp, {"tokens": toks}, mode="train")
    _, cache = tm.apply(tp, {"tokens": toks[:, :T]}, mode="prefill")
    got, cache = tm.apply(tp, {"tokens": toks[:, T:]}, mode="decode",
                          cache=cache)
    _close(got[:, 0], ref[:, T])
    assert cache["len"].tolist() == [[T + 1] * B] * tm.cfg.num_layers


def test_decode_writes_cache_in_place():
    """A decode step writes its K/V rows into the stacked cache tensors it
    was given (no copy of the cache), and returns new lengths."""
    _, tm, _, tp = _pair("granite-20b")
    toks = torch.as_tensor(_tokens(tm.cfg, 2, 9))
    _, cache = tm.apply(tp, {"tokens": toks[:, :8]}, mode="prefill")
    k, lens = cache["k"], cache["len"].clone()
    before = k[:, :, 8].clone()
    _, out = tm.apply(tp, {"tokens": toks[:, 8:]}, mode="decode", cache=cache)
    assert out["k"] is k and out["v"] is cache["v"]
    assert not torch.equal(k[:, :, 8], before)
    assert torch.equal(out["len"], lens + 1)


@pytest.mark.parametrize("arch", ["granite-20b", "chatglm3-6b"])
def test_impl_ref_equals_auto_on_cpu(arch):
    _, tm, _, tp = _pair(arch)
    toks = torch.as_tensor(_tokens(tm.cfg, 2, 12))
    a, _ = tm.apply(tp, {"tokens": toks}, mode="train")
    b, _ = tm.apply(tp, {"tokens": toks}, mode="train", impl="ref")
    assert torch.equal(a, b)


def test_threefry_init_matches_jax_init():
    """Model.init with the reference's seed gives its params (to a few
    ulp of the fp32 draw, exact after the bf16 cast almost everywhere)."""
    jm = jax_build(jax_smoke("granite-20b"))
    tm = build_model(get_smoke_config("granite-20b"))
    jp = jax.tree.leaves(jm.init(jax.random.key(5)))
    tp = leaves(tm.init(threefry.key(5), "cpu"))
    assert len(jp) == len(tp)
    for a, b in zip(jp, tp):
        np.testing.assert_allclose(_np(b), _np(a), rtol=8e-3, atol=1e-6)


def test_init_params_on_device_rules():
    """Same per-leaf rules and scales as init_leaf, drawn by a torch
    generator in slices; reproducible by seed, independent of the slice."""
    defs = {"w": pdef((6, 200, 50), (None, None, None), fan_in_axes=(1,)),
            "ones": pdef((7,), (None,), init="ones"),
            "z": pdef((3, 2), (None, None), dtype=torch.float32,
                      init="zeros"),
            "e": pdef((4000, 8), (None, None), init="embed"),
            "s": pdef((2,), (None,), dtype=torch.float32, init="scalar:0.5")}
    a = init_params_on_device(7, defs, "cpu")
    b = init_params_on_device(7, defs, "cpu", chunk_elements=10_000)
    c = init_params_on_device(8, defs, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))
    assert not torch.equal(a["w"], c["w"])
    assert a["w"].dtype == torch.bfloat16 and a["w"].shape == (6, 200, 50)
    assert abs(float(a["w"].float().std()) - 200 ** -0.5) < 0.005
    assert abs(float(a["e"].float().std()) - 1.0) < 0.05
    assert torch.equal(a["ones"], torch.ones(7, dtype=torch.bfloat16))
    assert torch.equal(a["z"], torch.zeros(3, 2))
    assert torch.equal(a["s"], torch.full((2,), 0.5))


def test_unported_families_raise():
    """The last two families once refused now build: the VLM stub on the
    decoder-only LM, the audio family on the encoder-decoder, with the
    reference's parameter counts."""
    from repro_torch.models import encdec, transformer
    for arch, apply in (("phi-3-vision-4.2b", transformer.lm_apply),
                        ("seamless-m4t-large-v2", encdec.encdec_apply)):
        tm = build_model(get_smoke_config(arch))
        assert tm._apply is apply
        assert tm.n_params == jax_build(jax_smoke(arch)).n_params


@pytest.mark.parametrize("arch", ["granite-20b", "chatglm3-6b"])
@pytest.mark.parametrize("spec", ["head/int8", "ring:4/int8"])
def test_int8_cache_logits_close(arch, spec):
    """tests/test_cache_spec.py's int8 check on the port, in its setting
    (params from seed 3, T 16, 4 teacher-forced decode steps, B 2): rms
    and scale-relative max error of the int8-cache logits against the
    bf16 cache's within 1e-2, greedy argmax equal on every step."""
    cfg = get_smoke_config(arch)
    base = build_model(cfg)
    q8 = build_model(dataclasses.replace(cfg, cache_spec=spec))
    params = base.init(threefry.key(3), "cpu")
    T, extra, B = 16, 4, 2
    toks = torch.as_tensor(_tokens(cfg, B, T + extra))

    def forced_logits(model):
        _, cache = model.apply(params, {"tokens": toks[:, :T]},
                               mode="prefill")
        out = []
        for i in range(extra):
            logits, cache = model.apply(
                params, {"tokens": toks[:, T + i:T + i + 1],
                         "positions": torch.full((B, 1), T + i,
                                                 dtype=torch.int32)},
                mode="decode", cache=cache)
            out.append(_np(logits[:, 0]))
        return np.stack(out, 1)

    ref, got = forced_logits(base), forced_logits(q8)
    d = np.abs(got - ref)
    assert np.sqrt((d ** 2).mean()) <= 1e-2, f"rms {np.sqrt((d**2).mean())}"
    rel_max = d.max() / np.abs(ref).max()
    assert rel_max <= 1e-2, f"scale-relative max error {rel_max:.4f}"
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))

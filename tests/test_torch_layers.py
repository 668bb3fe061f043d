"""The port's dense-LM layers and KV-cache convention (models/layers.py,
models/cache.py) against the JAX package's on the same numpy inputs,
params carried across with `from_reference`.

Tolerances: fp32 math to 1e-5; bf16 activations to 2e-2, the reference's
own decode tolerance (tests/test_decode_consistency.py).  JAX rounds each
op of gelu/silu in bf16 where torch rounds once, and JAX's attention casts
probabilities to bf16 before PV where the port's kernel keeps fp32, so
bf16 results differ in the last bit here and there.  int8 cache q and
scales are bit-equal on equal inputs."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke_config as jax_smoke
from repro.models import cache as jcache
from repro.models import layers as JL
from repro.models.param import init_params as jax_init
from repro_torch.configs import get_smoke_config
from repro_torch.models import cache as tcache
from repro_torch.models import layers as TL
from repro_torch.models.param import from_reference, stack_defs
from repro_torch.tree import leaves

BF16_TOL = 2e-2


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


def _close(got, want, tol=BF16_TOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _x(shape, seed=0, dtype=jnp.bfloat16, scale=1.0):
    xj = jnp.asarray(np.random.default_rng(seed).normal(size=shape) * scale,
                     dtype)
    return xj, from_reference(np.asarray(xj))


@pytest.mark.parametrize("dtype,tol", [(jnp.float32, 1e-5),
                                       (jnp.bfloat16, BF16_TOL)])
def test_norms_match(dtype, tol):
    xj, xt = _x((2, 5, 64), 1, dtype, scale=3.0)
    sj, st = _x((64,), 2, dtype)
    bj, bt = _x((64,), 3, dtype)
    _close(TL.rmsnorm(xt, st), JL.rmsnorm(xj, sj), tol)
    _close(TL.layernorm(xt, st, bt), JL.layernorm(xj, sj, bj), tol)
    _close(TL.apply_norm({"scale": st}, xt), JL.apply_norm({"scale": sj}, xj),
           tol)
    _close(TL.apply_norm({"scale": st, "bias": bt}, xt),
           JL.apply_norm({"scale": sj, "bias": bj}, xj), tol)
    cfg = get_smoke_config("minitron-8b")
    assert TL.norm_defs(cfg).keys() == {"scale", "bias"}


@pytest.mark.parametrize("name", ["silu", "gelu", "gelu_plain", "relu2"])
@pytest.mark.parametrize("dtype,tol", [(jnp.float32, 1e-5),
                                       (jnp.bfloat16, BF16_TOL)])
def test_act_fn_matches(name, dtype, tol):
    """gelu is jax.nn.gelu's tanh approximation, not torch's erf default
    (which differs from it by up to 5e-4 in fp32)."""
    xj, xt = _x((4, 300), 4, dtype, scale=3.0)
    _close(TL.act_fn(name)(xt), JL.act_fn(name)(xj), tol)


@pytest.mark.parametrize("fraction", [1.0, 0.5])
@pytest.mark.parametrize("dtype,tol", [(jnp.float32, 1e-5),
                                       (jnp.bfloat16, BF16_TOL)])
def test_rope_matches(fraction, dtype, tol):
    """fraction 0.5 rotates only the first half of D (chatglm's 2d RoPE);
    positions up to 4,000 exercise the fp32 angles."""
    xj, xt = _x((2, 7, 3, 16), 5, dtype)
    pos = np.random.default_rng(6).integers(0, 4000, (2, 7)).astype(np.int32)
    got = TL.rope_apply(xt, torch.as_tensor(pos), 10_000.0, fraction)
    want = JL.rope_apply(xj, jnp.asarray(pos), 10_000.0, fraction)
    assert got.dtype == xt.dtype
    _close(got, want, tol)
    if fraction < 1:
        assert torch.equal(got[..., 8:], xt[..., 8:])


def _layer_params(arch, build, seed):
    cfg = jax_smoke(arch)
    jp = jax_init(jax.random.key(seed), build(cfg))
    return cfg, jp, from_reference(jp)


@pytest.mark.parametrize("arch", ["chatglm3-6b", "granite-20b"])
def test_mlp_matches(arch):
    """chatglm3: gated SiLU; granite: plain tanh-GELU."""
    cfg, jp, tp = _layer_params(arch, JL.mlp_defs, 7)
    assert ("w_gate" in tp) == (arch == "chatglm3-6b")
    xj, xt = _x((2, 5, cfg.d_model), 8)
    _close(TL.mlp_apply(tp, cfg, xt), JL.mlp_apply(jp, cfg, xj))


def test_embed_unembed_match():
    cfg, jp, tp = _layer_params("qwen1.5-4b", JL.embed_defs, 9)
    toks = np.random.default_rng(10).integers(0, cfg.vocab_size, (2, 6))
    xj = JL.embed_apply(jp, jnp.asarray(toks, jnp.int32))
    xt = TL.embed_apply(tp, torch.as_tensor(toks.astype(np.int32)))
    np.testing.assert_array_equal(_np(xt), _np(xj))
    _close(TL.unembed_apply(tp, xt), JL.unembed_apply(jp, xj))
    tied = {"tok": tp["tok"]}
    _close(TL.unembed_apply(tied, xt),
           JL.unembed_apply({"tok": jp["tok"]}, xj))


def test_quantize_kv_bit_equal():
    """int8 q and scales equal the reference's on the same bf16 K/V rows
    (both widen bf16 exactly to fp32 before the rowwise quantisation)."""
    xj, xt = _x((2, 33, 3, 16), 11, scale=2.0)
    qj, sj = jcache.quantize_kv(xj)
    qt, st = tcache.quantize_kv(xt)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(
        _np(tcache.dequantize_kv(qt, st)), _np(jcache.dequantize_kv(qj, sj)))


@pytest.mark.parametrize("spec", ["head/bf16", "ring:4/bf16", "head/int8",
                                  "ring:4/int8", "replicated/bf16"])
def test_cache_defs_and_pack_match(spec):
    cfg = dataclasses.replace(get_smoke_config("chatglm3-6b"),
                              cache_spec=spec)
    jcfg = dataclasses.replace(jax_smoke("chatglm3-6b"), cache_spec=spec)
    td = tcache.attention_cache_defs(cfg, 3, 37)
    jd = jcache.attention_cache_defs(jcfg, 3, 37)
    assert {k: (d.shape, str(d.dtype).split(".")[-1]) for k, d in td.items()} \
        == {k: (d.shape, str(jnp.dtype(d.dtype))) for k, d in jd.items()}
    kj, kt = _x((3, 13, 2, 8), 12)
    vj, vt = _x((3, 13, 2, 8), 13)
    pj = jcache.pack_prefill_cache(jcfg, kj, vj, window=0)
    pt = tcache.pack_prefill_cache(cfg, kt, vt, window=0)
    assert pt.keys() == pj.keys()
    for key in pj:
        assert tuple(pt[key].shape) == pj[key].shape, key
        np.testing.assert_array_equal(_np(pt[key]), _np(pj[key]))
    assert tcache.CacheSpec.parse(spec).name == jcache.CacheSpec.parse(spec).name
    # one device: ring:0 is one segment, ring:n keeps n (power-of-two cut)
    for n, S in ((0, 64), (4, 64), (4, 18), (8, 12)):
        ts = tcache.CacheSpec("ring", "bf16", n)
        assert tcache.ring_segments(ts, S) == (
            1 if n == 0 else jcache.ring_segments(
                jcache.CacheSpec("ring", "bf16", n), S))


def test_pack_prefill_window_trims():
    cfg = dataclasses.replace(get_smoke_config("granite-20b"), window=8)
    jcfg = dataclasses.replace(jax_smoke("granite-20b"), window=8)
    kj, kt = _x((2, 13, 1, 16), 14)
    pj = jcache.pack_prefill_cache(jcfg, kj, kj, window=8)
    pt = tcache.pack_prefill_cache(cfg, kt, kt, window=8)
    for key in pj:
        np.testing.assert_array_equal(_np(pt[key]), _np(pj[key]))


def test_write_kv_in_place_per_row_slots():
    """Rows at different positions in one batch; a start past the end is
    clamped so the rows fit, as lax.dynamic_update_slice clamps."""
    for spec in ("head/bf16", "head/int8"):
        cfg = dataclasses.replace(get_smoke_config("chatglm3-6b"),
                                  cache_spec=spec)
        jcfg = dataclasses.replace(jax_smoke("chatglm3-6b"), cache_spec=spec)
        defs = tcache.attention_cache_defs(cfg, 3, 10)
        tc = {k: torch.zeros(d.shape, dtype=d.dtype) for k, d in defs.items()}
        jc = {k: jnp.zeros(d.shape, d.dtype) for k, d in
              jcache.attention_cache_defs(jcfg, 3, 10).items()}
        kj, kt = _x((3, 2, 2, 8), 15)
        vj, vt = _x((3, 2, 2, 8), 16)
        slots = np.array([0, 4, 9], np.int32)
        out = tcache.write_kv(tc, kt, vt, torch.as_tensor(slots))
        want = jcache.write_kv(jc, kj, vj, jnp.asarray(slots),
                               spec=jcache.spec_of(jcfg))
        for key in want:
            assert out[key] is tc[key]                    # in place
            np.testing.assert_array_equal(_np(out[key]), _np(want[key]))


@pytest.mark.parametrize("segments", [1, 4])
def test_decode_attention_matches(segments):
    qj, qt = _x((2, 1, 8, 16), 17)
    kj, kt = _x((2, 24, 2, 16), 18)
    vj, vt = _x((2, 24, 2, 16), 19)
    lens = np.array([5, 24], np.int32)
    if segments == 1:
        want = JL.decode_attention(qj, kj, vj, jnp.asarray(lens))
        got = TL.decode_attention(qt, kt, vt, torch.as_tensor(lens))
    else:
        want = JL.ring_decode_attention(qj, kj, vj, jnp.asarray(lens),
                                        segments=segments)
        got = TL.ring_decode_attention(qt, kt, vt, torch.as_tensor(lens),
                                       segments=segments)
    assert got.shape == (2, 1, 8, 16) and got.dtype == qt.dtype
    _close(got, want)
    plain = TL.decode_attention(qt, kt, vt, torch.as_tensor(lens))
    _close(got, plain)


def _attn_pair(arch, spec, seed=20):
    jcfg = dataclasses.replace(jax_smoke(arch), cache_spec=spec)
    cfg = dataclasses.replace(get_smoke_config(arch), cache_spec=spec)
    jp = jax_init(jax.random.key(seed), JL.attention_defs(jcfg))
    if jcfg.qkv_bias:     # zeros at init: give the biases real values
        for name in ("bq", "bk", "bv"):
            jp[name] = jnp.asarray(np.random.default_rng(seed).normal(
                size=jp[name].shape) * 0.1, jnp.bfloat16)
    return jcfg, cfg, jp, from_reference(jp)


@pytest.mark.parametrize("arch", ["granite-20b", "chatglm3-6b"])
@pytest.mark.parametrize("spec", ["head/bf16", "ring:4/bf16", "head/int8",
                                  "ring:4/int8"])
def test_attention_apply_train_prefill_decode(arch, spec):
    """Train and prefill outputs, the packed cache, then three decode steps
    (outputs and caches) against the reference's attention_apply."""
    jcfg, cfg, jp, tp = _attn_pair(arch, spec)
    B, T = 2, 11
    xj, xt = _x((B, T + 3, cfg.d_model), 21)
    pos = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    yj, _ = JL.attention_apply(jp, jcfg, xj[:, :T], jnp.asarray(pos))
    yt, _ = TL.attention_apply(tp, cfg, xt[:, :T], torch.as_tensor(pos))
    _close(yt, yj)
    yj, cj = JL.attention_apply(jp, jcfg, xj[:, :T], jnp.asarray(pos),
                                mode="prefill")
    yt, ct = TL.attention_apply(tp, cfg, xt[:, :T], torch.as_tensor(pos),
                                mode="prefill")
    _close(yt, yj)
    assert ct.keys() == cj.keys()
    for i in range(3):
        p = np.full((B, 1), T + i, np.int32)
        yj, cj = JL.attention_apply(jp, jcfg, xj[:, T + i:T + i + 1],
                                    jnp.asarray(p), mode="decode", cache=cj)
        yt, ct = TL.attention_apply(tp, cfg, xt[:, T + i:T + i + 1],
                                    torch.as_tensor(p), mode="decode",
                                    cache=ct)
        _close(yt, yj)
        np.testing.assert_array_equal(ct["len"].numpy(), np.asarray(cj["len"]))
        for key in ct:
            if key.endswith("scale"):        # per-row amax / 127 of K/V
                _close(ct[key], cj[key])
            elif ct[key].dtype == torch.int8:  # q may move by one step
                d = np.abs(ct[key].numpy().astype(int)
                           - np.asarray(cj[key]).astype(int))
                assert d.max() <= 1 and (d > 0).mean() < 0.05, key
            else:
                _close(ct[key], cj[key])


def test_select_attention_refuses_offsets(monkeypatch):
    """Queries at an offset are no longer refused: they take the
    reference's plain routes, chosen by shape.  T == S with the int offset
    0 stays on the flash_attention kernel (its plain version here); an
    offset (a nonzero int, or any tensor) goes to attention_full up to
    4,096 positions, the triangular schedule for long causal T == S, the
    blockwise scan otherwise."""
    _, qt = _x((1, 4, 2, 8), 22)
    _, kt = _x((1, 6, 2, 8), 23)
    routed = TL.select_attention(qt, kt, kt, q_offset=torch.tensor(2))
    assert torch.equal(routed, TL.attention_full(qt, kt, kt, q_offset=2))
    _, k4 = _x((1, 4, 2, 8), 24)
    flash = TL.select_attention(qt, k4, k4)
    assert torch.equal(flash, TL.flash_ops.flash_attention(
        qt, k4, k4, causal=True, window=0, impl="ref"))
    assert torch.equal(TL.select_attention(qt, k4, k4, q_offset=1),
                       TL.attention_full(qt, k4, k4, q_offset=1))
    taken = []
    for name in ("flash_attention_xla", "flash_attention_xla_triangular",
                 "attention_full"):
        monkeypatch.setattr(TL, name, lambda *a, _n=name, **k:
                            taken.append((_n, k.get("q_offset"))))
    monkeypatch.setattr(TL.flash_ops, "flash_attention",
                        lambda *a, **k: taken.append(("kernel", None)))
    long = torch.zeros((1, 8192, 1, 8), dtype=torch.bfloat16)
    short = long[:, :512]
    TL.select_attention(long, long, long, q_offset=torch.tensor(0))
    TL.select_attention(short, long, long, q_offset=torch.tensor(7680))
    TL.select_attention(long, long, long, window=64, q_offset=3)
    TL.select_attention(short, long[:, :4096], long[:, :4096], q_offset=5)
    TL.select_attention(long, long, long)
    assert [n for n, _ in taken] == [
        "flash_attention_xla_triangular", "flash_attention_xla",
        "flash_attention_xla", "attention_full", "kernel"]
    assert [int(o) for _, o in taken[:4]] == [0, 7680, 3, 5]


def test_stack_defs_matches_reference():
    from repro.models.param import stack_defs as jstack
    cfg = get_smoke_config("chatglm3-6b")
    td = leaves(stack_defs(TL.attention_defs(cfg), 3))
    jd = jax.tree.leaves(jstack(JL.attention_defs(jax_smoke("chatglm3-6b")),
                                3),
                         is_leaf=lambda d: hasattr(d, "fan_in_axes"))
    assert [(d.shape, d.logical_axes, d.init, d.fan_in_axes) for d in td] == \
        [(d.shape, d.logical_axes, d.init, d.fan_in_axes) for d in jd]

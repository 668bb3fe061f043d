"""The port's last two model families against the JAX package on their
smoke configs, params carried across with `from_reference`:

  phi-3-vision-4.2b      vlm: the decoder-only LM with the vision stub's
                         patch embeddings occupying the prompt's prefix
  seamless-m4t-large-v2  audio: the encoder-decoder (models/encdec.py),
                         a non-causal encoder over stub frames, a decoder
                         with cross attention and a static cross cache

Configs, param / cache / input defs, train-mode logits, prefill logits and
every cache leaf (self K/V and, for the enc-dec, the cross K/V and its
lengths), and three teacher-forced decode steps, held as
tests/test_torch_lm.py holds the dense LMs: scale-relative max 2e-2 and
rms 1e-2 (the port's T == S attention keeps P in fp32 where the
reference's `attention_full` rounds it to bf16).  Then the port against
its own teacher forcing (the enc-dec with frames one longer than the
tokens: its cross attention at T != S takes the plain route), the patch
prefix bit for bit, the serve batch's draws, and the serve loops.
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
from repro.models import encdec as jax_encdec
from repro.models import layers as jax_layers
from repro.models import transformer as jax_transformer
from repro.models.config import SHAPES as JAX_SHAPES
from repro_torch import threefry
from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.launch import serve
from repro_torch.launch.serve_loop import (PagedServeLoop, Request,
                                          ServeLoop)
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import build_model, encdec, layers, transformer
from repro_torch.models.config import SHAPES
from repro_torch.models.param import from_reference
from repro_torch.tree import leaves, tree_map

VLM, AUDIO = "phi-3-vision-4.2b", "seamless-m4t-large-v2"
ARCHS = [VLM, AUDIO]
TOL = 2e-2
N_PARAMS = {VLM: 3_821_079_552, AUDIO: 1_632_256_000}


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


def _pair(arch, seed=3):
    jm, tm = jax_build(jax_smoke(arch)), build_model(get_smoke_config(arch))
    jp = jm.init(jax.random.key(seed))
    return jm, tm, jp, from_reference(jp)


def _batch(cfg, B, T, seed=0, frames=None):
    """numpy inputs as the reference's tests draw them: tokens, patch
    embeddings, frames (`frames` positions, default T)."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)}
    if cfg.frontend == "vision_stub":
        b["patch_embeds"] = rng.normal(size=(B, cfg.frontend_len,
                                             cfg.d_model))
    if cfg.is_encdec:
        b["frames"] = rng.normal(size=(B, frames or T, cfg.d_model))
    return b


def _jax_in(b):
    return {k: jnp.asarray(v, jnp.bfloat16 if v.dtype == np.float64
                           else None) for k, v in b.items()}


def _torch_in(b):
    return {k: torch.as_tensor(v).to(torch.bfloat16 if v.dtype == np.float64
                                     else torch.int32)
            for k, v in b.items()}


def _defs_key(d):
    return (d.shape, str(d.dtype).split(".")[-1], d.init, d.fan_in_axes,
            d.logical_axes)


def _jax_defs_keys(defs):
    return [(d.shape, str(jnp.dtype(d.dtype)), d.init, d.fan_in_axes,
             d.logical_axes)
            for d in jax.tree.leaves(
                defs, is_leaf=lambda d: hasattr(d, "fan_in_axes"))]


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_defs_match_jax(arch):
    assert arch in list_archs()
    for tget, jget in ((get_config, jax_get_config),
                       (get_smoke_config, jax_smoke)):
        assert dataclasses.asdict(tget(arch)) == dataclasses.asdict(jget(arch))
        tm, jm = build_model(tget(arch)), jax_build(jget(arch))
        assert tm.n_params == jm.n_params
        assert tm.supports_cache_spec == jm.supports_cache_spec
        assert tm.supports_paged_cache == jm.supports_paged_cache
        for tdefs, jdefs in ((tm.param_defs(), jm.param_defs()),
                             (tm.cache_defs(2, 40), jm.cache_defs(2, 40))):
            assert [_defs_key(d) for d in leaves(tdefs)] == \
                _jax_defs_keys(jdefs)
    assert build_model(get_config(arch)).n_params == N_PARAMS[arch]


@pytest.mark.parametrize("shape", list(JAX_SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_defs_match_jax(arch, shape):
    for tget, jget in ((get_config, jax_get_config),
                       (get_smoke_config, jax_smoke)):
        tdefs = build_model(tget(arch)).input_defs(SHAPES[shape])
        jdefs = jax_build(jget(arch)).input_defs(JAX_SHAPES[shape])
        assert list(tdefs) == list(jdefs)
        assert [_defs_key(d) for d in tdefs.values()] == \
            _jax_defs_keys(list(jdefs.values()))


@pytest.mark.parametrize("arch", ARCHS)
def test_threefry_init_matches_jax_init(arch):
    """Model.init walks the enc-dec's tree in jax.tree's leaf order, so
    one seed gives the reference's params."""
    jm, tm = jax_build(jax_smoke(arch)), build_model(get_smoke_config(arch))
    jp = jax.tree.leaves(jm.init(jax.random.key(5)))
    tp = leaves(tm.init(threefry.key(5), "cpu"))
    assert len(jp) == len(tp)
    for a, b in zip(jp, tp):
        np.testing.assert_allclose(_np(b), _np(a), rtol=8e-3, atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_logits_match_jax(arch):
    jm, tm, jp, tp = _pair(arch)
    b = _batch(jm.cfg, 2, 19)
    jl, jaux = jm.apply(jp, _jax_in(b), mode="train")
    tl, taux = tm.apply(tp, _torch_in(b), mode="train")
    assert tl.dtype == torch.bfloat16 and tuple(tl.shape) == jl.shape
    assert taux == 0.0 and float(jaux) == 0.0
    _close(tl, jl)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    """Prefill logits and every cache leaf (lengths exactly), then three
    teacher-forced decode steps (each step's logits and every cache leaf
    after it)."""
    jm, tm, jp, tp = _pair(arch, seed=4)
    B, T = 2, 16
    b = _batch(jm.cfg, B, T + 3, seed=1, frames=T)
    toks = b.pop("tokens")
    b["tokens"] = toks[:, :T]
    jl, jc = jm.apply(jp, _jax_in(b), mode="prefill")
    tl, tc = tm.apply(tp, _torch_in(b), mode="prefill")
    assert tl.shape == (B, 1, jm.cfg.vocab_size)
    _close(tl, jl)

    def caches_close():
        jflat = jax.tree_util.tree_flatten_with_path(jc)[0]
        tflat = leaves(tc)
        assert len(jflat) == len(tflat)
        for (path, a), t in zip(jflat, tflat):
            assert tuple(t.shape) == a.shape, jax.tree_util.keystr(path)
            if a.dtype == jnp.int32:
                np.testing.assert_array_equal(t.numpy(), np.asarray(a))
            else:
                _close(t, a)

    caches_close()
    for i in range(3):
        step = {"tokens": toks[:, T + i:T + i + 1],
                "positions": np.full((B, 1), T + i, np.int32)}
        jl, jc = jm.apply(jp, _jax_in(step), mode="decode", cache=jc)
        tl, tc = tm.apply(tp, _torch_in(step), mode="decode", cache=tc)
        _close(tl, jl)
        caches_close()


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_teacher_forcing(arch):
    """The port against itself, as tests/test_decode_consistency.py holds
    the reference: T + 1 positions in train mode against a prefill of T
    tokens and one decode step.  The enc-dec's frames have T + 1
    positions in both, so its prefill's cross attention (T queries over
    T + 1 keys) takes the plain route."""
    _, tm, _, tp = _pair(arch, seed=1)
    B, T = 2, 16
    full = _torch_in(_batch(tm.cfg, B, T + 1, seed=2))
    ref, _ = tm.apply(tp, full, mode="train")
    _, cache = tm.apply(tp, {**full, "tokens": full["tokens"][:, :T]},
                        mode="prefill")
    got, cache = tm.apply(tp, {"tokens": full["tokens"][:, T:]},
                          mode="decode", cache=cache)
    _close(got[:, 0], ref[:, T])
    lens = cache["self"]["len"] if arch == AUDIO else cache["len"]
    assert lens.tolist() == [[T + 1] * B] * tm.cfg.num_layers


def test_patch_prefix_bit_equal_to_jax():
    """The embedding with the patch prefix, bit for bit: the first
    frontend_len positions are the patch embeddings cast to bf16, the
    rest the token embeddings."""
    jm, tm, jp, tp = _pair(VLM)
    b = _batch(jm.cfg, 2, 13)
    want = jax_transformer._embed_inputs(jp, jm.cfg, _jax_in(b))
    got = transformer._embed_inputs(tp, tm.cfg, _torch_in(b))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(_np(got), _np(want))
    P = tm.cfg.frontend_len
    assert torch.equal(got[:, :P], _torch_in(b)["patch_embeds"])
    # no patch embeddings (decode, text-only prompts): tokens alone
    plain = transformer._embed_inputs(tp, tm.cfg,
                                      {"tokens": _torch_in(b)["tokens"]})
    assert torch.equal(plain[:, P:], got[:, P:])


def test_prompt_shorter_than_the_patch_prefix_is_refused():
    """The reference lengthens such a sequence to frontend_len; the port
    refuses it."""
    _, tm, _, tp = _pair(VLM)
    b = _torch_in(_batch(tm.cfg, 2, tm.cfg.frontend_len - 1))
    with pytest.raises(ValueError, match="patch embeddings"):
        tm.apply(tp, b, mode="prefill")
    b = _torch_in(_batch(tm.cfg, 2, tm.cfg.frontend_len))
    logits, _ = tm.apply(tp, b, mode="prefill")
    assert bool(torch.isfinite(logits.float()).all())


@pytest.mark.parametrize("kind,T,S", [("cross", 9, 9), ("cross", 7, 12),
                                      ("encoder", 9, 9)])
def test_attention_apply_cross_and_non_causal_match_jax(kind, T, S):
    """attention_apply of the enc-dec's blocks against the reference's:
    cross attention (no RoPE, keys from kv_source; T == S takes the
    kernel's plain version, T != S attention_full) and the encoder's
    non-causal self attention."""
    jm, tm, jp, tp = _pair(AUDIO)
    rng = np.random.default_rng(T + S)
    x = rng.normal(size=(2, T, tm.cfg.d_model))
    pos = np.tile(np.arange(T, dtype=np.int32), (2, 1))
    block = "cross_attn" if kind == "cross" else "self_attn"
    jlp = jax.tree.map(lambda a: a[0], jp["dec_layers"][block])
    tlp = tree_map(lambda a: a[0], tp["dec_layers"][block])
    if kind == "cross":
        src = rng.normal(size=(2, S, tm.cfg.d_model))
        kw_j = {"kv_source": jnp.asarray(src, jnp.bfloat16)}
        kw_t = {"kv_source": torch.as_tensor(src).bfloat16()}
    else:
        kw_j = kw_t = {"causal": False}
    jy, _ = jax_layers.attention_apply(
        jlp, jm.cfg, jnp.asarray(x, jnp.bfloat16), jnp.asarray(pos),
        mode="train", **kw_j)
    ty, _ = layers.attention_apply(
        tlp, tm.cfg, torch.as_tensor(x).bfloat16(), torch.as_tensor(pos),
        mode="train", **kw_t)
    _close(ty, jy)


def test_cross_prefill_cache_and_decode():
    """A prefill with kv_source returns the cross cache {k, v, len}: the
    reference's separately computed einsums; a cross decode step reads it
    and returns it unchanged."""
    jm, tm, jp, tp = _pair(AUDIO)
    cfg = tm.cfg
    rng = np.random.default_rng(5)
    src = rng.normal(size=(2, 11, cfg.d_model))
    x = rng.normal(size=(2, 11, cfg.d_model))
    tlp = tree_map(lambda a: a[1], tp["dec_layers"]["cross_attn"])
    jlp = jax.tree.map(lambda a: a[1], jp["dec_layers"]["cross_attn"])
    pos = torch.arange(11, dtype=torch.int32)[None].expand(2, 11)
    _, cc = layers.attention_apply(
        tlp, cfg, torch.as_tensor(x).bfloat16(), pos, mode="prefill",
        kv_source=torch.as_tensor(src).bfloat16())
    jsrc = jnp.asarray(src, jnp.bfloat16)
    for name, w in (("k", "wk"), ("v", "wv")):
        want = jnp.einsum("bsd,dhk->bshk", jsrc, jlp[w])
        np.testing.assert_array_equal(_np(cc[name]), _np(want))
    assert cc["len"].tolist() == [11, 11]
    q = torch.as_tensor(rng.normal(size=(2, 1, cfg.d_model))).bfloat16()
    y, out = layers.attention_apply(tlp, cfg, q, pos[:, :1], mode="decode",
                                    cache=cc, is_cross=True)
    assert out is cc and y.shape == (2, 1, cfg.d_model)
    jy, _ = jax_layers.attention_apply(
        jlp, jm.cfg, jnp.asarray(_np(q), jnp.bfloat16),
        jnp.zeros((2, 1), jnp.int32), mode="decode",
        cache={k: jnp.asarray(_np(v), jnp.bfloat16 if k != "len" else
                              jnp.int32) for k, v in cc.items()},
        is_cross=True)
    _close(y, jy)


def test_encode_matches_jax():
    jm, tm, jp, tp = _pair(AUDIO, seed=6)
    frames = np.random.default_rng(6).normal(size=(2, 21, tm.cfg.d_model))
    want = jax_encdec.encode(jp, jm.cfg, jnp.asarray(frames, jnp.bfloat16))
    got = encdec.encode(tp, tm.cfg, torch.as_tensor(frames).bfloat16())
    _close(got, want)
    assert encdec.enc_len_for(5000) == jax_encdec.enc_len_for(5000) == 4096


@pytest.mark.parametrize("arch", ARCHS)
def test_impl_ref_equals_auto_on_cpu(arch):
    _, tm, _, tp = _pair(arch)
    b = _torch_in(_batch(tm.cfg, 2, 12))
    a, _ = tm.apply(tp, b, mode="train")
    r, _ = tm.apply(tp, b, mode="train", impl="ref")
    assert torch.equal(a, r)


@pytest.mark.parametrize("arch", ARCHS)
def test_make_batch_equals_reference_draws(arch):
    """serve.make_batch draws what the reference's launch/serve.py draws,
    in its order and with its bf16 casts, bit for bit."""
    cfg = get_smoke_config(arch)
    B, T = 3, 11
    got = serve.make_batch(cfg, np.random.default_rng(7), B, T, "cpu")
    # the reference's serve.py, lines 144-153
    rng = np.random.default_rng(7)
    want = {"tokens": jnp.asarray(
        rng.integers(0, cfg.vocab_size, (B, T)), jnp.int32)}
    if cfg.frontend == "vision_stub":
        want["patch_embeds"] = jnp.asarray(
            rng.normal(size=(B, cfg.frontend_len, cfg.d_model)), jnp.bfloat16)
    if cfg.is_encdec:
        want["frames"] = jnp.asarray(
            rng.normal(size=(B, T, cfg.d_model)), jnp.bfloat16)
    assert sorted(got) == sorted(want)
    for key in want:
        assert str(got[key].dtype).split(".")[-1] == str(want[key].dtype)
        np.testing.assert_array_equal(_np(got[key]), _np(want[key]))


def _solo(model, params, prompt, max_new):
    prefill, decode = make_prefill_step(model), make_decode_step(model)
    nxt, cache = prefill(params, {"tokens": torch.as_tensor(prompt[None])})
    out = [int(nxt[0])]
    for pos in range(len(prompt), len(prompt) + max_new - 1):
        nxt, cache = decode(params, {
            "tokens": nxt[:, None],
            "positions": torch.full((1, 1), pos, dtype=torch.int32)}, cache)
        out.append(int(nxt[0]))
    return out


def test_serve_loop_serves_the_vlm_as_solo():
    """Text prompts through the VLM's ServeLoop (the reference's loops
    pass tokens only): every stream equal to the request served alone."""
    model = build_model(get_smoke_config(VLM))
    params = model.init(threefry.key(0), "cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, model.cfg.vocab_size, n).astype(np.int32)
               for n in (1, 12, 7, 19)]
    loop = ServeLoop(model, params, max_batch=2, max_len=64)
    for i, p in enumerate(prompts):
        loop.submit(Request(rid=i, prompt=p, max_new=5))
    got = {r.rid: r.out for r in loop.run_until_drained()}
    for i, p in enumerate(prompts):
        assert got[i] == _solo(model, params, p, 5), i


def test_paged_loop_serves_the_vlm():
    model = build_model(get_smoke_config(VLM))
    params = model.init(threefry.key(1), "cpu")
    rng = np.random.default_rng(1)
    loop = PagedServeLoop(model, params, max_batch=2, num_blocks=16,
                          block_size=4, chunk=8)
    for i, n in enumerate((5, 13, 9)):
        loop.submit(Request(rid=i, prompt=rng.integers(
            0, model.cfg.vocab_size, n).astype(np.int32), max_new=4))
    done = loop.run_until_drained()
    assert sorted(r.rid for r in done) == [0, 1, 2]
    assert all(len(r.out) == 4 for r in done)


def test_serve_loops_refuse_the_enc_dec():
    """The reference's ServeLoop cannot serve the enc-dec (its prefill
    passes no frames); the port's refuses it, and the paged loop refuses
    its static cross cache."""
    model = build_model(get_smoke_config(AUDIO))
    params = model.init(threefry.key(0), "cpu")
    with pytest.raises(NotImplementedError, match="fixed-batch"):
        ServeLoop(model, params, max_batch=2, max_len=32)
    with pytest.raises(ValueError, match="paged"):
        PagedServeLoop(model, params, max_batch=2)


@pytest.mark.parametrize("arch", ARCHS)
def test_logits_gap_hooks_reach_every_kind_of_attention(arch):
    """examples/logits_gap.py's readings set chip_smoke.py's logits
    tolerances for these archs, so its planted faults must reach each
    kind of attention (the enc-dec's encoder, decoder self and cross
    attention): at smoke size on the CPU (the plain versions) the shipped
    path reads 0 and each fault moves the last position's logits."""
    from repro_torch.examples import logits_gap
    tm = build_model(get_smoke_config(arch))
    params = tm.init(threefry.key(0), "cpu")
    batch = serve.make_batch(tm.cfg, np.random.default_rng(1), 2, 40, "cpu")
    kinds = logits_gap.attention_kinds(tm.cfg)
    assert set(kinds) == ({"self", "encoder", "cross"} if arch == AUDIO
                          else {"self"})
    plain = logits_gap.prefill_logits(tm, params, batch, impl="ref")
    runs = {"kernels": {}, "half_window": {
        "attention": logits_gap.half_window}}
    runs.update({kind: {"attention": logits_gap.drop_head_at(at)}
                 for kind, at in kinds.items()})
    gaps = {}
    for name, kw in runs.items():
        got = logits_gap.prefill_logits(tm, params, batch, **kw)
        gaps[name] = float((got - plain).abs().max() / plain.abs().max())
    assert gaps.pop("kernels") == 0.0
    assert min(gaps.values()) > 0.0, gaps

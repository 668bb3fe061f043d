"""The port's paged serving path and contiguous chunked prefill against the
JAX package on the same numpy inputs (params carried across with
`from_reference`), and the port's PagedServeLoop against its own
contiguous ServeLoop.

Layers: paged_kv_write and paged_gather_kv bit-equal, rows at position -1
dropped; paged_chunk_attention, attention_full and the blockwise routes at
a query offset within 1e-5 in fp32 and the LM tolerance in bf16.  Model:
paged chunk_prefill then paged decode (granite-20b: MQA; chatglm3-6b:
GQA, partial rope, qkv bias) and contiguous chunk_prefill into the specs
None, ring:4/bf16 and head/int8, logits held as tests/test_torch_lm.py
holds them (2e-2 scale-relative, 1e-2 rms).

Loops: the paged prefill attends on the reference's plain route (P
rounded to bf16), the contiguous prefill on the flash kernel's plain
version (P in fp32), so greedy streams may part where the two best logits
nearly tie.  The logits behind every token are recorded in both loops and
held within 2e-2 scale-relative while the streams share their context; a
stream may part only where the contiguous run's two best logits lie within
twice that step's difference (examples/serve_load.divergence).
"""
import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke_config as jax_smoke
from repro.models import build_model as jax_build
from repro.models import layers as JL
from repro.models.param import is_def
from repro_torch import threefry
from repro_torch.configs import get_smoke_config
from repro_torch.examples import parity_gap, serve_load
from repro_torch.launch import loadgen, serve
from repro_torch.launch.serve_loop import PagedServeLoop, Request, ServeLoop
from repro_torch.launch.steps import make_chunk_prefill_step
from repro_torch.models import build_model
from repro_torch.models import layers as TL
from repro_torch.models.param import from_reference
from repro_torch.tree import tree_map

TOL = 2e-2


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _close(got, want, tol=TOL):
    """tests/test_torch_lm.py's measure: scale-relative max and rms."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    d = np.abs(got - want)
    assert d.max() <= tol * np.abs(want).max(), \
        f"scale-relative max {d.max() / np.abs(want).max():.4f}"
    assert np.sqrt((d ** 2).mean()) <= tol / 2, \
        f"rms {np.sqrt((d ** 2).mean()):.4f}"


def _x(shape, seed, dtype=jnp.bfloat16):
    xj = jnp.asarray(np.random.default_rng(seed).normal(size=shape), dtype)
    return xj, from_reference(np.asarray(xj))


def _pair(arch, seed=3, spec="auto"):
    jm = jax_build(dataclasses.replace(jax_smoke(arch), cache_spec=spec))
    tm = build_model(dataclasses.replace(get_smoke_config(arch),
                                         cache_spec=spec))
    jp = jm.init(jax.random.key(seed))
    return jm, tm, jp, from_reference(jp)


def _tokens(cfg, B, T, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, T)).astype(np.int32)


# -- layers -----------------------------------------------------------------

def _pool_case(seed=0):
    nb, bs, hkv, d = 7, 4, 2, 8
    kp, kpt = _x((nb, bs, hkv, d), seed)
    vp, vpt = _x((nb, bs, hkv, d), seed + 1)
    bt = np.array([[3, 0, 5, 0], [6, 1, 2, 4]], np.int32)
    return nb, bs, (kp, kpt), (vp, vpt), bt


def _with_sink(pool):
    return torch.cat([pool, torch.full_like(pool[:1], 7.0)])


@pytest.mark.parametrize("positions", [
    [[1, 2, 3, -1, -1], [9, 10, 11, 12, 13]],
    [[-1, -1, -1, -1, -1], [0, 1, 2, 3, 4]],
    [[-1, -1, -1, -1, -1], [-1, -1, -1, -1, -1]]])
def test_paged_write_and_gather_bit_equal(positions):
    nb, bs, (kp, kpt), (vp, vpt), bt = _pool_case()
    pos = np.array(positions, np.int32)
    kk, kkt = _x((2, 5, 2, 8), 5)
    vv, vvt = _x((2, 5, 2, 8), 6)
    jk, jv = JL.paged_kv_write(kp, vp, jnp.asarray(bt), kk, vv,
                               jnp.asarray(pos))
    # the port's pool carries one sink block past the NB that tables name
    tk, tv = TL.paged_kv_write(_with_sink(kpt), _with_sink(vpt),
                               torch.as_tensor(bt), kkt, vvt,
                               torch.as_tensor(pos))
    tk, tv = tk[:nb], tv[:nb]
    assert np.array_equal(_np(tk), _np(jk)) and np.array_equal(_np(tv),
                                                               _np(jv))
    # a dropped row leaves the pool as it was
    if (pos < 0).all():
        assert torch.equal(tk, kpt) and torch.equal(tv, vpt)
    gk, gv = JL.paged_gather_kv(jk, jv, jnp.asarray(bt))
    hk, hv = TL.paged_gather_kv(tk, tv, torch.as_tensor(bt))
    assert hk.shape == (2, bt.shape[1] * bs, 2, 8)
    assert np.array_equal(_np(hk), _np(gk)) and np.array_equal(_np(hv),
                                                               _np(gv))


@pytest.mark.parametrize("dtype,tol", [(jnp.float32, 1e-5),
                                       (jnp.bfloat16, TOL)])
def test_paged_chunk_attention_matches(dtype, tol):
    q, qt = _x((2, 6, 4, 8), 10, dtype)
    k, kt = _x((2, 16, 2, 8), 11, dtype)
    v, vt = _x((2, 16, 2, 8), 12, dtype)
    pos = np.array([[4, 5, 6, 7, -1, -1], [9, 10, 11, 12, 13, 14]], np.int32)
    want = JL.paged_chunk_attention(q, k, v, jnp.asarray(pos))
    got = TL.paged_chunk_attention(qt, kt, vt, torch.as_tensor(pos))
    assert got.dtype == qt.dtype
    np.testing.assert_allclose(_np(got)[pos >= 0], _np(want)[pos >= 0],
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("q_offset", [0, 5, 24])
@pytest.mark.parametrize("window", [0, 7])
@pytest.mark.parametrize("dtype,tol", [(jnp.float32, 1e-5),
                                       (jnp.bfloat16, TOL)])
def test_attention_at_an_offset_matches(dtype, tol, window, q_offset):
    """attention_full and flash_attention_xla (blocks of 8 and 4) at a
    query offset, against the reference's, on the same q, k, v."""
    T, S = 8, 32
    q, qt = _x((2, T, 4, 8), 20, dtype)
    k, kt = _x((2, S, 2, 8), 21, dtype)
    v, vt = _x((2, S, 2, 8), 22, dtype)
    for jfn, tfn, kw in (
            (JL.attention_full, TL.attention_full, {}),
            (JL.flash_attention_xla, TL.flash_attention_xla,
             {"q_block": 4, "kv_block": 8})):
        want = jfn(q, k, v, causal=True, window=window, q_offset=q_offset,
                   **kw)
        got = tfn(qt, kt, vt, causal=True, window=window,
                  q_offset=torch.tensor(q_offset), **kw)
        assert got.dtype == qt.dtype
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype,tol", [(jnp.float32, 1e-5),
                                       (jnp.bfloat16, TOL)])
def test_triangular_schedule_matches(dtype, tol):
    q, qt = _x((1, 16, 2, 8), 30, dtype)
    k, kt = _x((1, 16, 1, 8), 31, dtype)
    v, vt = _x((1, 16, 1, 8), 32, dtype)
    want = JL.flash_attention_xla_triangular(q, k, v, q_offset=3, block=4)
    got = TL.flash_attention_xla_triangular(qt, kt, vt, q_offset=3, block=4)
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)
    # with no offset the triangle is the rectangle's causal part: equal to
    # the blockwise route over every kv block
    tri = TL.flash_attention_xla_triangular(qt, kt, vt, block=4)
    rect = TL.flash_attention_xla(qt, kt, vt, q_block=4, kv_block=4)
    assert torch.equal(tri, rect)


def test_paged_refuses_sliding_windows():
    cfg = dataclasses.replace(get_smoke_config("granite-20b"), window=8)
    model = build_model(cfg)
    params = model.init(threefry.key(0), "cpu")
    pages = tree_map(lambda d: torch.zeros(d.shape, dtype=d.dtype),
                     model.paged_cache_defs(1, 4, 4, 4))
    with pytest.raises(ValueError, match="sliding"):
        model.apply(params, {
            "tokens": torch.zeros((1, 4), dtype=torch.int32),
            "positions": torch.arange(4, dtype=torch.int32)[None],
            "block_tables": pages["bt"][0],
            "last_index": torch.tensor([3], dtype=torch.int32)},
            mode="chunk_prefill", cache={"kp": pages["kp"],
                                         "vp": pages["vp"]})


# -- model ------------------------------------------------------------------

def _jax_pages(jm, B, nb, bs):
    defs = jm.paged_cache_defs(B, nb, bs, nb)
    z = jax.tree.map(lambda d: jnp.zeros(d.shape, d.dtype), defs,
                     is_leaf=is_def)
    return {"kp": z["kp"], "vp": z["vp"]}


@pytest.mark.parametrize("arch", ["granite-20b", "chatglm3-6b"])
def test_paged_chunk_prefill_then_decode_matches(arch):
    """tests/test_decode_consistency.py:67 on the port: chunked, bucketed
    prefill through the block pool, then paged decode steps, against the
    port's own teacher forcing, and every chunk's and step's logits
    against the JAX package's, on two sequences with scattered block
    tables.  The port's train mode keeps P in fp32 (the flash kernel's
    plain version) where its chunk path rounds P to bf16, so teacher
    forcing is held as JAX is, scale-relative, not to an absolute
    2e-2."""
    jm, tm, jp, tp = _pair(arch, seed=7)
    cfg = tm.cfg
    B, T, extra = 2, 13, 3
    bs, chunk, nb = 4, 8, 10
    L = cfg.num_layers
    toks = _tokens(cfg, B, T + extra, seed=7)
    with torch.no_grad():
        ref_logits, _ = tm.apply(tp, {"tokens": torch.as_tensor(toks)})
    bt = np.array([[9, 2, 4, 0, 7], [1, 8, 3, 6, 5]], np.int32)
    jpages = _jax_pages(jm, B, nb, bs)
    tpages = tree_map(lambda d: torch.zeros(d.shape, dtype=d.dtype),
                      {k: v for k, v in tm.paged_cache_defs(
                          B, nb, bs, nb).items() if k in ("kp", "vp")})
    step = make_chunk_prefill_step(tm)
    pos = 0
    while pos < T:
        c = min(chunk, T - pos)
        cb = c if c == chunk else 1 << (c - 1).bit_length()
        tk = np.zeros((B, cb), np.int32)
        tk[:, :c] = toks[:, pos: pos + c]
        pv = np.full((B, cb), -1, np.int32)
        pv[:, :c] = np.arange(pos, pos + c)
        batch = {"tokens": tk, "positions": pv, "block_tables": bt,
                 "last_index": np.full((B,), c - 1, np.int32)}
        jl, jpages = jm.apply(jp, {k: jnp.asarray(v) for k, v in
                                   batch.items()}, mode="chunk_prefill",
                              cache=jpages)
        with torch.no_grad():
            tl, tpages = tm.apply(tp, {k: torch.as_tensor(v) for k, v in
                                       batch.items()}, mode="chunk_prefill",
                                  cache=tpages)
        assert tl.shape == (B, 1, cfg.vocab_size)
        _close(tl, jl)
        nxt, _ = step(tp, {k: torch.as_tensor(v) for k, v in batch.items()},
                      {k: v.clone() for k, v in tpages.items()})
        assert torch.equal(nxt, torch.argmax(tl[:, -1].float(), dim=-1))
        pos += c
    _close(tl[:, 0], ref_logits[:, T - 1])
    for i in range(extra):
        dec = {"tokens": toks[:, T + i: T + i + 1],
               "positions": np.full((B, 1), T + i, np.int32)}
        lens = np.full((L, B), T + i, np.int32)
        jcache = {**jpages, "bt": jnp.broadcast_to(jnp.asarray(bt),
                                                   (L,) + bt.shape),
                  "len": jnp.asarray(lens)}
        jl, jc = jm.apply(jp, {k: jnp.asarray(v) for k, v in dec.items()},
                          mode="decode", cache=jcache)
        jpages = {"kp": jc["kp"], "vp": jc["vp"]}
        tcache = {**tpages, "bt": torch.as_tensor(bt).expand(L, *bt.shape),
                  "len": torch.as_tensor(lens)}
        with torch.no_grad():
            tl, tc = tm.apply(tp, {k: torch.as_tensor(v) for k, v in
                                   dec.items()}, mode="decode", cache=tcache)
        assert torch.equal(tc["len"], torch.as_tensor(lens) + 1)
        _close(tl, jl)
        _close(tl[:, 0], ref_logits[:, T + i])
    _close(tpages["kp"][:, :nb], jpages["kp"])
    _close(tpages["vp"][:, :nb], jpages["vp"])


def _scale_relative(got, want):
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("spec", ["auto", "ring:4/bf16", "head/int8"])
@pytest.mark.parametrize("arch", ["granite-20b", "chatglm3-6b"])
def test_contiguous_chunk_prefill_matches(arch, spec):
    """tests/test_torch_lm.py::test_prefill_and_decode_match_jax's setting
    (params seed 4, a 2 x 16 prompt from token seed 1, 3 teacher-forced
    decode steps) with the prompt through contiguous chunk_prefill in 4
    chunks of 4 into a cache of 24 positions, against the JAX package
    with the same spec: the prefill's logits (the last chunk's) and each
    decode step's at that test's 2e-2 scale-relative and 1e-2 rms; the
    earlier chunks' at 2e-2 scale-relative (their rms reads 0.005-0.0106
    against the frameworks' train-mode gap of 0.008).  The last chunk
    also holds the port's own one-shot prefill into the spec."""
    jm, tm, jp, tp = _pair(arch, seed=4, spec=spec)
    cfg = tm.cfg
    B, T, C, S, extra = 2, 16, 4, 24, 3
    toks = _tokens(cfg, B, T + extra, seed=1)
    jcache = jax.tree.map(lambda d: jnp.zeros(d.shape, d.dtype),
                          jm.cache_defs(B, S), is_leaf=is_def)
    tcache = tree_map(lambda d: torch.zeros(d.shape, dtype=d.dtype),
                      tm.cache_defs(B, S))
    for pos in range(0, T, C):
        batch = {"tokens": toks[:, pos: pos + C],
                 "positions": np.broadcast_to(
                     np.arange(pos, pos + C, dtype=np.int32), (B, C)),
                 "last_index": np.full((B,), C - 1, np.int32)}
        jl, jcache = jm.apply(jp, {k: jnp.asarray(v) for k, v in
                                   batch.items()}, mode="chunk_prefill",
                              cache=jcache)
        with torch.no_grad():
            tl, tcache = tm.apply(tp, {k: torch.as_tensor(np.array(v))
                                       for k, v in batch.items()},
                                  mode="chunk_prefill", cache=tcache)
        assert (tcache["len"] == pos + C).all()
        assert _scale_relative(tl, jl) <= TOL
    _close(tl, jl)
    with torch.no_grad():
        one_shot, _ = tm.apply(tp, {"tokens": torch.as_tensor(toks[:, :T])},
                               mode="prefill")
    _close(tl, one_shot)
    for i in range(extra):
        dec = {"tokens": toks[:, T + i: T + i + 1],
               "positions": np.full((B, 1), T + i, np.int32)}
        jl, jcache = jm.apply(jp, {k: jnp.asarray(v) for k, v in
                                   dec.items()}, mode="decode", cache=jcache)
        with torch.no_grad():
            tl, tcache = tm.apply(tp, {k: torch.as_tensor(v) for k, v in
                                       dec.items()}, mode="decode",
                                  cache=tcache)
        _close(tl, jl)


# -- loops ------------------------------------------------------------------

def _model(seed):
    model = build_model(get_smoke_config("granite-20b"))
    return model, model.init(threefry.key(seed), "cpu")


def _drain_both(model, params, prompts, max_new, contiguous, paged):
    """The prompts through a contiguous ServeLoop and a PagedServeLoop,
    the logits behind every token recorded in both; -> (paged streams,
    contiguous streams, verdicts, the paged loop).  The paged loop's
    invariants are checked after every tick."""
    cloop = ServeLoop(model, params, **contiguous)
    want_rows = serve_load.record_logits(cloop)
    ploop = PagedServeLoop(model, params, **paged)
    got_rows = serve_load.record_logits(ploop)
    for loop in (cloop, ploop):
        for i, p in enumerate(prompts):
            loop.submit(Request(rid=i, prompt=p, max_new=max_new))
    want = {r.rid: r.out for r in cloop.run_until_drained()}
    got = {}
    while ploop.live or ploop.queue:
        got.update({r.rid: r.out for r in ploop.tick()})
        ploop.alloc.check_invariants()
    assert sorted(got) == sorted(want) == list(range(len(prompts)))
    assert all(len(o) == max_new for o in got.values())
    verdicts = [serve_load.divergence(got[i], want[i], got_rows[i],
                                      want_rows[i])
                for i in range(len(prompts))]
    assert all(kind != "mismatch" for kind, _ in verdicts), \
        (verdicts, got, want)
    return got, want, verdicts, ploop


def test_paged_matches_contiguous_mid_flight_joins():
    """5 requests through 2 slots: chunked and bucketed prefill, paged
    decode, slot reuse after release."""
    model, params = _model(0)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, model.cfg.vocab_size, n).astype(np.int32)
               for n in (12, 7, 19, 33, 5)]
    *_, ploop = _drain_both(model, params, prompts, 8,
                            dict(max_batch=2, max_len=128),
                            dict(max_batch=2, num_blocks=32, block_size=8,
                                 chunk=16))
    assert not ploop.alloc.tables and ploop.alloc.n_free() == 32
    assert sorted(ploop.free) == [0, 1] and not ploop.live
    # 33 tokens in chunks of 16: 16, 16, a 1-token tail bucket
    assert ploop.chunk_steps == 1 + 1 + 2 + 3 + 1


def test_paged_prefix_sharing():
    """Three prompts with a 24-token common prefix: the later two re-use
    its 3 full blocks (no recompute) and still follow the contiguous
    streams."""
    model, params = _model(3)
    rng = np.random.default_rng(3)
    base = rng.integers(0, model.cfg.vocab_size, 24).astype(np.int32)
    prompts = [np.concatenate([base, rng.integers(
        0, model.cfg.vocab_size, k).astype(np.int32)]) for k in (5, 3, 9)]
    *_, ploop = _drain_both(model, params, prompts, 5,
                            dict(max_batch=3, max_len=128),
                            dict(max_batch=3, num_blocks=32, block_size=8,
                                 chunk=16))
    assert ploop.alloc.stats["shared_blocks"] >= 6


def test_paged_preemption_requeues():
    """A pool too small for all admitted sequences forces preemption; the
    requeued request still follows its contiguous stream."""
    model, params = _model(4)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, model.cfg.vocab_size, n).astype(np.int32)
               for n in (21, 23, 22)]
    # 9 blocks x 8 = 72 positions for 3 x (>= 21 + 16) at once
    *_, ploop = _drain_both(model, params, prompts, 16,
                            dict(max_batch=3, max_len=128),
                            dict(max_batch=3, num_blocks=9, block_size=8,
                                 chunk=16))
    assert ploop.preemptions >= 1


def _short_trace(vocab):
    return loadgen.generate(dataclasses.replace(
        serve_load._load_cfg(vocab, shared=True), duration_s=1.0))


def test_parity_catches_a_planted_paged_fault():
    """The parity check has teeth: with the last row of every block read
    as zeros (parity_gap.planted_fault), the paged logits leave the
    contiguous ones by more than the tolerance and streams are flagged,
    where the clean run on the same trace stays within it."""
    model, params = _model(6)
    trace = _short_trace(model.cfg.vocab_size)
    clean = serve_load.parity(model, params, trace)
    with parity_gap.planted_fault():
        ploop, _ = serve_load._loops(model, params)
        fault = serve_load.compare(serve_load.replay(ploop, trace),
                                   clean["contiguous"])
    assert clean["mismatches"] == 0
    assert clean["logits_diff"] <= serve_load.LOGITS_TOL
    assert fault["mismatches"] > 0
    assert fault["logits_diff"] > serve_load.LOGITS_TOL


def test_paged_equals_contiguous_at_the_same_rounding_points():
    """With the contiguous prefill on the reference's XLA route (P rounded
    to bf16, as the paged prefill rounds it; parity_gap.
    reference_rounding), the paged loop follows the contiguous one token
    for token, its logits within 1e-3 scale-relative (they read 0 on the
    CPU): what parity against the flash-kernel prefill excuses as rounding
    is rounding."""
    model, params = _model(7)
    trace = _short_trace(model.cfg.vocab_size)
    ploop, _ = serve_load._loops(model, params)
    paged = serve_load.replay(ploop, trace)
    with parity_gap.reference_rounding():
        matched = serve_load.replay(serve_load._loops(model, params)[1],
                                    trace)
    res = serve_load.compare(paged, matched, tol=1e-3)
    assert res["tokens_agree"] == res["tokens"] > 0
    assert res["mismatches"] == 0 and res["logits_diff"] <= 1e-3


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "recurrentgemma-9b"])
def test_paged_rejects_stateful_families(arch):
    model = build_model(get_smoke_config(arch))
    assert not model.supports_paged_cache
    with pytest.raises(ValueError, match="paged"):
        PagedServeLoop(model, {})
    with pytest.raises(ValueError, match="paged"):
        model.paged_cache_defs(1, 4, 4, 4)


def test_paged_loop_counters_and_dtypes():
    model, params = _model(5)
    loop = PagedServeLoop(model, params, max_batch=2, num_blocks=8,
                          block_size=8)
    assert loop.lengths.dtype == np.int32 and loop._next.dtype == torch.int32
    assert set(loop.pages) == {"kp", "vp"}
    # 8 blocks and the sink of dropped writes
    assert loop.pages["kp"].shape == (model.cfg.num_layers, 9, 8, 1, 16)
    assert (loop.decode_steps, loop.chunk_steps) == (0, 0)
    with pytest.raises(ValueError, match="multiple"):
        PagedServeLoop(model, params, block_size=8, chunk=12)


# -- entry points -----------------------------------------------------------

@pytest.mark.parametrize("argv", [
    [], ["--batch", "2", "--prompt-len", "40", "--gen", "6",
         "--num-blocks", "7", "--block-size", "8"]])
def test_serve_main_paged_on_cpu(argv, capsys):
    res = serve.main(["--paged", "--device", "cpu", *argv])
    batch = int(argv[argv.index("--batch") + 1]) if argv else 4
    gen = int(argv[argv.index("--gen") + 1]) if argv else 32
    assert res["requests"] == 2 * batch
    assert res["tokens_out"] == 2 * batch * gen
    assert all(len(r.out) == gen and r.done for r in res["done"])
    loop = res["loop"]
    loop.alloc.check_invariants()
    assert not loop.alloc.tables and loop.alloc.n_free() == res["pool"][0]
    # CPU: plain versions only; the paged prefill attention never reaches
    # the flash kernel
    assert all(n == 0 for n in res["launches"].values())
    if not argv:   # the reference's pool sizing: 4 x (64 + 32) + 16
        assert res["pool"] == (25, 16)
    out = capsys.readouterr().out
    assert "[serve] paged loop" in out and "ms per decode tick" in out


def _jax_harness():
    """The JAX package's benchmarks/serve_load.py, as a module."""
    import importlib.util
    path = Path(__file__).resolve().parents[1] / "benchmarks" / \
        "serve_load.py"
    spec = importlib.util.spec_from_file_location("jax_serve_load", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _record_jax_paged(jloop):
    """Make the JAX package's PagedServeLoop keep the logits behind each
    token it emits, as serve_load.record_logits does for the port's: its
    jitted steps are re-jitted to return the last position's logits
    beside their outputs.  -> {rid: {index in out: (V,) fp32 row}}."""
    model, seen, last = jloop.model, {}, {}
    rows, pending = {}, {}

    class Recorded:
        def __getattr__(self, name):
            return getattr(model, name)

        def apply(self, *args, **kw):
            seen["logits"], cache = model.apply(*args, **kw)
            return seen["logits"], cache

    def logged(impl):
        def fn(*args):
            return impl(*args), seen["logits"][:, -1].astype(jnp.float32)
        return jax.jit(fn, donate_argnums=(1,))

    jloop.model = Recorded()
    chunk, decode = logged(jloop._chunk_impl), logged(jloop._decode_impl)
    prefill_chunks, admit = jloop._prefill_chunks, jloop._admit

    def chunk_logged(*args):
        out, last["row"] = chunk(*args)
        return out

    def decode_logged(*args):
        out, lg = decode(*args)
        lg = np.array(lg)
        for slot, req in jloop.live.items():
            rows[req.rid][len(req.out)] = torch.from_numpy(lg[slot])
        return out

    def prefill_logged(slot, *args):
        out = prefill_chunks(slot, *args)
        pending[slot] = torch.from_numpy(np.array(last["row"][0]))
        return out

    def admit_logged():
        before = dict(jloop.live)
        admit()
        for slot, req in jloop.live.items():
            if before.get(slot) is not req:
                rows[req.rid] = {0: pending.pop(slot)}

    jloop._chunk_prefill, jloop._decode = chunk_logged, decode_logged
    jloop._prefill_chunks, jloop._admit = prefill_logged, admit_logged
    return rows


def test_serve_load_parity_matches_jax_harness():
    """examples/serve_load.py takes the JAX harness's workload (ARCH, QPS,
    DURATION_S, POOL, the load configs), and its virtual-clock parity pass
    on granite-20b smoke gives the request count and shared blocks of the
    harness's own parity pass (the second half of its measure(); 32 and
    18 with JAX 0.9.0, as BENCH_serve.json records), no unexplained
    divergence, and the allocator's invariants after every tick.  The
    port's paged streams follow the JAX paged loop's (the same rounding
    points, other frameworks) under serve_load.divergence, the logits
    behind every token recorded in both."""
    bench = _jax_harness()
    assert (serve_load.ARCH, serve_load.QPS, serve_load.DURATION_S,
            serve_load.POOL) == (bench.ARCH, bench.QPS, bench.DURATION_S,
                                 bench.POOL)
    jmodel = jax_build(jax_smoke(bench.ARCH))
    vocab = jmodel.cfg.vocab_size
    for shared in (False, True):
        assert dataclasses.asdict(serve_load._load_cfg(vocab, shared)) == \
            dataclasses.asdict(bench._load_cfg(vocab, shared))
    jtrace = bench.loadgen.generate(bench._load_cfg(vocab, shared=True))
    jloop, _ = bench._loops(jmodel, jmodel.init(jax.random.key(0)))
    jrows = _record_jax_paged(jloop)
    jrecs = bench.loadgen.run_trace(jloop, jtrace, tick_s=0.01)
    want = {"n_requests": len(jtrace),
            "shared_blocks": jloop.alloc.stats["shared_blocks"]}
    recorded = json.loads((Path(bench.BENCH_PATH)).read_text())["parity"]

    model, params = serve_load.load_model("cpu")
    trace = loadgen.generate(serve_load._load_cfg(vocab, shared=True))
    res = serve_load.parity(model, params, trace,
                            on_tick=lambda lp: lp.alloc.check_invariants())
    assert {k: res[k] for k in want} == want == \
        {k: recorded[k] for k in want}
    assert res["mismatches"] == 0
    jax_paged = serve_load.compare(res["paged"],
                                   {"records": jrecs, "rows": jrows})
    assert jax_paged["mismatches"] == 0, jax_paged["verdicts"]

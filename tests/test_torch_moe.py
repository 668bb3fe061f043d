"""The port's MoE family (models/layers.py moe_*, the transformer's moe
block, model_factory's "moe" row, the mixtral-8x22b and
qwen3-moe-235b-a22b configs) against the JAX package on the same numpy
inputs, params carried across with `from_reference`.

  * configs, param and cache defs, n_params and n_active_params: equal;
  * moe_capacity and _moe_groups over a grid: equal;
  * moe_route against the reference's routing steps on the same
    probabilities, ties included: gidx, pos and keep equal;
  * moe_apply with every param in fp32, dropless (capacity factor 0 and
    8.0), dropping (1.25 and 0.25) and all ties (w_router = 0): within
    1e-5 (a routing difference would show as an O(1) error), aux within
    1e-6; in bf16 at tests/test_torch_lm.py's scale-relative 2e-2;
  * both smoke archs: train logits and the summed aux, prefill logits and
    cache, three teacher-forced decode steps, at 2e-2 (test_torch_lm.py's
    measure); qwen3-moe smoke's prefill-then-decode against its own
    teacher forcing (tests/test_decode_consistency.py);
  * in those model runs the two frameworks' bf16 activations differ by
    an ulp here and there (test_torch_lm.py), and a token whose router
    probabilities nearly tie can then choose another expert, which moves
    its hidden state by O(1) (qwen3-moe smoke, params seed 3: a 4th and
    5th choice 0.26 % apart read 0.038 scale-relative).  So each MoE
    layer's routing is held to JAX's (`_routing_held_to_jax`): the port's
    own choices must equal the choices JAX makes on its probabilities,
    except at a near tie (the two probabilities JAX ranks at the first
    rank where they part lie within twice the token's largest
    probability difference, serve_load.divergence's rule), and the layer
    then runs on JAX's routing, so the logits compare at 2e-2;
  * qwen3-moe smoke through ServeLoop and PagedServeLoop against the JAX
    loops, the logits behind every token recorded in both and held under
    examples/serve_load.divergence (the loop parity tests' rule); one
    contiguous chunk_prefill whose tail chunk is padded, against JAX;
  * mixtral smoke (a sliding window) in the paged loop raises ValueError.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke
from repro.launch.serve_loop import PagedServeLoop as JaxPagedServeLoop
from repro.launch.serve_loop import Request as JaxRequest
from repro.launch.serve_loop import ServeLoop as JaxServeLoop
from repro.models import build_model as jax_build
from repro.models import layers as JL
from repro.models.param import is_def
from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.examples import serve_load
from repro_torch.launch.serve_loop import PagedServeLoop, Request, ServeLoop
from repro_torch.models import build_model
from repro_torch.models import layers as TL
from repro_torch.models.param import from_reference
from repro_torch.tree import leaves, tree_map

MOE = ["mixtral-8x22b", "qwen3-moe-235b-a22b"]
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


def _pair(arch, seed=3):
    jm = jax_build(jax_smoke(arch))
    tm = build_model(get_smoke_config(arch))
    jp = jm.init(jax.random.key(seed))
    return jm, tm, jp, from_reference(jp)


def _tokens(cfg, B, T, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, T)).astype(np.int32)


# -- configs ----------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE)
def test_configs_and_defs_match_jax(arch):
    assert arch in list_archs()
    for tget, jget in ((get_config, jax_get_config),
                       (get_smoke_config, jax_smoke)):
        assert dataclasses.asdict(tget(arch)) == dataclasses.asdict(jget(arch))
        tm, jm = build_model(tget(arch)), jax_build(jget(arch))
        assert (tm.n_params, tm.n_active_params) == \
            (jm.n_params, jm.n_active_params)
        for tdefs, jdefs in ((tm.param_defs(), jm.param_defs()),
                             (tm.cache_defs(2, 40), jm.cache_defs(2, 40))):
            jl = jax.tree.leaves(jdefs, is_leaf=is_def)
            assert [(d.shape, str(d.dtype).split(".")[-1], d.init,
                     d.fan_in_axes) for d in leaves(tdefs)] == \
                [(d.shape, str(jnp.dtype(d.dtype)), d.init, d.fan_in_axes)
                 for d in jl]
    if arch == "mixtral-8x22b":
        full = build_model(get_config(arch))
        assert (full.n_params, full.n_active_params) == \
            (140_630_071_296, 39_161_468_928)


def test_capacity_and_groups_match_jax():
    base = jax_smoke("mixtral-8x22b")
    for B in (1, 2, 3, 4, 6, 8, 16):
        for T in (1, 7, 64, 511, 1024, 2048, 4096):
            assert TL._moe_groups(B, T) == JL._moe_groups(B, T), (B, T)
    for E, k in ((8, 2), (128, 8), (4, 2)):
        for cf in (0.0, -1.0, 0.25, 1.0, 1.25, 2.0, 8.0):
            cfg = dataclasses.replace(base, num_experts=E,
                                      experts_per_token=k,
                                      capacity_factor=cf)
            for tokens in (1, 4, 16, 40, 100, 2048, 8192):
                assert TL.moe_capacity(cfg, tokens) == \
                    JL.moe_capacity(cfg, tokens), (E, k, cf, tokens)


def _reference_route(probs, k, C):
    """The reference's routing steps (layers.py moe_apply), in jnp."""
    G, ng, E = probs.shape
    gval, gidx = jax.lax.top_k(probs, k)
    gval = gval / jnp.maximum(gval.sum(-1, keepdims=True), 1e-9)
    onehot = jax.nn.one_hot(gidx, E, dtype=jnp.int32)
    flat = onehot.transpose(0, 2, 1, 3).reshape(G, k * ng, E)
    pos_flat = jnp.cumsum(flat, axis=1) - flat
    pos = (pos_flat.reshape(G, k, ng, E).transpose(0, 2, 1, 3)
           * onehot).sum(-1)
    return gval, gidx, pos, pos < C


@pytest.mark.parametrize("E,k,C", [(8, 2, 8), (8, 4, 16), (16, 8, 24),
                                   (4, 2, 1000)])
def test_moe_route_matches_reference_steps(E, k, C):
    """Probabilities rounded to a coarse grid, so most rows hold ties."""
    rng = np.random.default_rng(E * k)
    p = np.round(rng.random((2, 50, E)) * 4) / 4 + 1 / 64
    p = (p / p.sum(-1, keepdims=True)).astype(np.float32)
    p[0, :5] = 1 / E                                    # rows of all ties
    want = _reference_route(jnp.asarray(p), k, C)
    got = TL.moe_route(torch.from_numpy(p), k, C)
    for w, g in zip(want[1:], got[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-6)
    assert not got[3].all() or C == 1000


# -- the layer ---------------------------------------------------------------

def _moe_case(arch, cf, ties, B, T, dtype=jnp.float32, seed=0):
    cfg = dataclasses.replace(jax_smoke(arch), capacity_factor=cf)
    p = jax.tree.map(lambda a: a[0], jax_build(cfg).init(
        jax.random.key(seed))["layers"]["moe"])
    if dtype == jnp.float32:       # bf16 keeps the defs' dtypes
        p = jax.tree.map(lambda a: a.astype(jnp.float32), p)
    if ties:
        p["w_router"] = jnp.zeros_like(p["w_router"])
    x = jnp.asarray(np.random.default_rng(seed).normal(
        size=(B, T, cfg.d_model)), dtype)
    return cfg, p, x


def _dropped(cfg, p, x):
    """Choices the layer drops, from the port's own routing."""
    B, T, d = x.shape
    G = TL._moe_groups(B, T)
    C = TL.moe_capacity(cfg, B * T // G)
    probs = torch.softmax(from_reference(x).float().reshape(G, -1, d)
                          @ from_reference(p["w_router"]).float(), dim=-1)
    return int((~TL.moe_route(probs, cfg.experts_per_token, C)[3]).sum())


@pytest.mark.parametrize("B,T", [(2, 40), (4, 1024)])
@pytest.mark.parametrize("cf,ties,drops", [
    (0.0, False, False), (8.0, False, False), (1.25, False, None),
    (0.25, False, True), (1.25, True, True)])
@pytest.mark.parametrize("arch", MOE)
def test_moe_apply_fp32_matches_jax(arch, cf, ties, drops, B, T):
    """Every param in fp32: output within 1e-5, aux within 1e-6.  (4,
    1024) routes in 2 groups of 2,048 tokens."""
    cfg, p, x = _moe_case(arch, cf, ties, B, T)
    yj, aj = JL.moe_apply(p, cfg, x)
    yt, at = TL.moe_apply(from_reference(p), cfg, from_reference(x))
    assert yt.dtype == torch.float32 and tuple(yt.shape) == yj.shape
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-5,
                               rtol=0)
    assert abs(float(at) - float(aj)) <= 1e-6
    if drops is not None:
        assert (_dropped(cfg, p, x) > 0) == drops
    if ties:    # every token on experts 0..k-1: E * k * (1/k) * (1/E)
        assert float(at) == pytest.approx(1.0)


@pytest.mark.parametrize("cf", [0.0, 1.25])
@pytest.mark.parametrize("arch", MOE)
def test_moe_apply_bf16_matches_jax(arch, cf):
    cfg, p, x = _moe_case(arch, cf, False, 2, 40, dtype=jnp.bfloat16,
                          seed=1)
    yj, aj = JL.moe_apply(p, cfg, x)
    yt, at = TL.moe_apply(from_reference(p), cfg,
                          from_reference(np.asarray(x)))
    assert yt.dtype == torch.bfloat16
    _close(yt, yj)
    assert abs(float(at) - float(aj)) <= 1e-6


# -- the model ---------------------------------------------------------------

@contextlib.contextmanager
def _routing_held_to_jax():
    """JAX runs eagerly and keeps each MoE layer's router probabilities;
    the port's i-th `moe_route` call takes JAX's i-th, checks its own
    choices against the choices JAX makes on them (equal, or parting at a
    near tie), and returns JAX's routing.  Yields the partings (group,
    token, rank, gap); each JAX call must precede the port's."""
    seen, parted = [], []
    jax_apply, route = JL.moe_apply, TL.moe_route

    def jax_moe(p, cfg, x):
        B, T, d = x.shape
        xg = x.reshape(JL._moe_groups(B, T), -1, d).astype(jnp.float32)
        seen.append(np.array(jax.nn.softmax(
            jnp.einsum("gnd,de->gne", xg, p["w_router"]), axis=-1)))
        return jax_apply(p, cfg, x)

    def port_route(probs, k, C):
        want = torch.from_numpy(seen.pop(0))
        own, held = route(probs, k, C), route(want, k, C)
        diff = (probs - want).abs().amax(-1)
        ranked = want.sort(-1, descending=True).values
        for g, t in (own[1] != held[1]).any(-1).nonzero().tolist():
            r = int((own[1][g, t] != held[1][g, t]).nonzero()[0])
            gap = float(ranked[g, t, r] - ranked[g, t, r + 1])
            assert gap <= 2 * float(diff[g, t]), \
                f"routing parts at token {t}, rank {r}: gap {gap}"
            parted.append((g, t, r, gap))
        return held

    JL.moe_apply, TL.moe_route = jax_moe, port_route
    try:
        with jax.disable_jit():
            yield parted
        assert not seen, f"{len(seen)} JAX MoE calls without a port call"
    finally:
        JL.moe_apply, TL.moe_route = jax_apply, route


@pytest.mark.parametrize("arch", MOE)
def test_train_logits_and_aux_match_jax(arch):
    jm, tm, jp, tp = _pair(arch)
    toks = _tokens(jm.cfg, 2, 19)
    with _routing_held_to_jax():
        jl, jaux = jm.apply(jp, {"tokens": jnp.asarray(toks)}, mode="train")
        tl, taux = tm.apply(tp, {"tokens": torch.as_tensor(toks)},
                            mode="train")
    assert tl.dtype == torch.bfloat16 and tuple(tl.shape) == jl.shape
    _close(tl, jl)
    # summed over the layers; each layer's is >= 1 (equality at balance)
    assert float(jaux) >= jm.cfg.num_layers * (1 - 1e-6)
    assert abs(float(taux) - float(jaux)) <= TOL * float(jaux)


@pytest.mark.parametrize("arch", MOE)
def test_prefill_and_decode_match_jax(arch):
    """Prefill logits and cache, then three teacher-forced decode steps
    (each step's logits and the caches after it)."""
    jm, tm, jp, tp = _pair(arch, seed=4)
    B, T = 2, 16
    toks = _tokens(jm.cfg, B, T + 3, seed=1)
    with _routing_held_to_jax():
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
            tl, tc = tm.apply(tp, {k: torch.as_tensor(v)
                                   for k, v in b.items()},
                              mode="decode", cache=tc)
            _close(tl, jl)
            np.testing.assert_array_equal(tc["len"].numpy(),
                                          np.asarray(jc["len"]))
            _close(tc["k"], jc["k"])
            _close(tc["v"], jc["v"])


def test_prefill_then_decode_matches_teacher_forcing():
    """tests/test_decode_consistency.py's MoE case on the port: qwen3-moe
    smoke is dropless, so decoding token T after a prefill of T tokens
    must give the train-mode logits at position T."""
    _, tm, _, tp = _pair("qwen3-moe-235b-a22b", seed=1)
    B, T = 2, 16
    toks = torch.as_tensor(_tokens(tm.cfg, B, T + 1, seed=2))
    ref, _ = tm.apply(tp, {"tokens": toks}, mode="train")
    _, cache = tm.apply(tp, {"tokens": toks[:, :T]}, mode="prefill")
    got, cache = tm.apply(tp, {"tokens": toks[:, T:]}, mode="decode",
                          cache=cache)
    _close(got[:, 0], ref[:, T])
    np.testing.assert_allclose(_np(got[:, 0]), _np(ref[:, T]), rtol=2e-2,
                               atol=2e-2)
    assert cache["len"].tolist() == [[T + 1] * B] * tm.cfg.num_layers


def test_contiguous_chunk_prefill_with_padded_tail_matches_jax():
    """A 2 x 13 prompt in chunks of 4 into a contiguous cache of 24
    positions: the last chunk holds one token and three padding rows
    (position -1), which are routed and take capacity as in the
    reference.  Each chunk's logits (at its last valid row) against
    JAX's."""
    jm, tm, jp, tp = _pair("qwen3-moe-235b-a22b", seed=4)
    B, T, C, S = 2, 13, 4, 24
    toks = _tokens(tm.cfg, B, T, seed=1)
    jcache = jax.tree.map(lambda d: jnp.zeros(d.shape, d.dtype),
                          jm.cache_defs(B, S), is_leaf=is_def)
    tcache = tree_map(lambda d: torch.zeros(d.shape, dtype=d.dtype),
                      tm.cache_defs(B, S))
    with _routing_held_to_jax():
        for pos in range(0, T, C):
            c = min(C, T - pos)
            tk = np.zeros((B, C), np.int32)
            tk[:, :c] = toks[:, pos:pos + c]
            pv = np.full((B, C), -1, np.int32)
            pv[:, :c] = np.arange(pos, pos + c)
            batch = {"tokens": tk, "positions": pv,
                     "last_index": np.full((B,), c - 1, np.int32)}
            jl, jcache = jm.apply(jp, {k: jnp.asarray(v) for k, v in
                                       batch.items()}, mode="chunk_prefill",
                                  cache=jcache)
            with torch.no_grad():
                tl, tcache = tm.apply(tp, {k: torch.as_tensor(v) for k, v in
                                           batch.items()},
                                      mode="chunk_prefill", cache=tcache)
            np.testing.assert_array_equal(tcache["len"].numpy(),
                                          np.asarray(jcache["len"]))
            _close(tl, jl)
    assert c == 1


# -- the loops ---------------------------------------------------------------

def _record_jax(jloop):
    """Make a JAX ServeLoop or PagedServeLoop keep the logits behind each
    token it emits, as serve_load.record_logits does for the port's: its
    jitted steps are re-jitted to return the last position's logits beside
    their outputs.  -> {rid: {index in out: (V,) fp32 row}}."""
    model, seen, last = jloop.model, {}, {}
    rows, pending = {}, {}
    paged = isinstance(jloop, JaxPagedServeLoop)

    class Recorded:
        def __getattr__(self, name):
            return getattr(model, name)

        def apply(self, *args, **kw):
            seen["logits"], cache = model.apply(*args, **kw)
            return seen["logits"], cache

    def logged(impl, donate):
        def fn(*args):
            return impl(*args), seen["logits"][:, -1].astype(jnp.float32)
        return jax.jit(fn, donate_argnums=donate)

    jloop.model = Recorded()
    decode = logged(jloop._decode_impl, (1,))
    if paged:
        step, name = logged(jloop._chunk_impl, (1,)), "_chunk_prefill"
        prefilled = "_prefill_chunks"
    else:
        step, name = logged(jloop._prefill_impl, ()), "_prefill"
        prefilled = "_write_slot"
    inner, admit = getattr(jloop, prefilled), jloop._admit

    def step_logged(*args):
        out, last["row"] = step(*args)
        return out

    def decode_logged(*args):
        out, lg = decode(*args)
        lg = np.array(lg)
        for slot, req in jloop.live.items():
            rows[req.rid][len(req.out)] = torch.from_numpy(lg[slot])
        return out

    def prefilled_logged(slot, *args):
        out = inner(slot, *args)
        pending[slot] = torch.from_numpy(np.array(last["row"][0]))
        return out

    def admit_logged():
        before = dict(jloop.live)
        admit()
        for slot, req in jloop.live.items():
            if before.get(slot) is not req:
                rows[req.rid] = {0: pending.pop(slot)}

    setattr(jloop, name, step_logged)
    setattr(jloop, prefilled, prefilled_logged)
    jloop._decode, jloop._admit = decode_logged, admit_logged
    return rows


def _drain(loop, reqs, rows):
    for r in reqs:
        loop.submit(r)
    done = {r.rid: r.out for r in loop.run_until_drained()}
    assert sorted(done) == list(range(len(reqs)))
    return done, rows


@pytest.mark.parametrize("paged", [False, True])
def test_serve_loops_match_jax(paged):
    """qwen3-moe smoke: 5 requests through 2 slots (mid-flight joins,
    slot reuse; paged: chunks of 16, a tail bucket) in the port's loop and
    the JAX package's, the logits behind every token recorded in both:
    within serve_load.LOGITS_TOL while the streams share their context,
    parting only at a near-tie."""
    jm, tm, jp, tp = _pair("qwen3-moe-235b-a22b", seed=0)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tm.cfg.vocab_size, n).astype(np.int32)
               for n in (12, 7, 19, 33, 5)]
    new = 6
    if paged:
        kw = dict(max_batch=2, num_blocks=32, block_size=8, chunk=16)
        jloop, tloop = JaxPagedServeLoop(jm, jp, **kw), \
            PagedServeLoop(tm, tp, **kw)
    else:
        jloop, tloop = JaxServeLoop(jm, jp, max_batch=2, max_len=64), \
            ServeLoop(tm, tp, max_batch=2, max_len=64)
    want, want_rows = _drain(jloop, [JaxRequest(rid=i, prompt=p, max_new=new)
                                     for i, p in enumerate(prompts)],
                             _record_jax(jloop))
    got, got_rows = _drain(tloop, [Request(rid=i, prompt=p, max_new=new)
                                   for i, p in enumerate(prompts)],
                           serve_load.record_logits(tloop))
    verdicts = [serve_load.divergence(got[i], want[i], got_rows[i],
                                      want_rows[i])
                for i in range(len(prompts))]
    assert all(kind != "mismatch" for kind, _ in verdicts), \
        (verdicts, got, want)
    assert all(len(got[i]) == new for i in got)
    if paged:
        tloop.alloc.check_invariants()
        assert not tloop.alloc.tables


def test_paged_loop_refuses_a_sliding_window():
    """mixtral-8x22b has a sliding window, which the block pool does not
    hold: its paged loop raises ValueError where the reference asserts."""
    _, tm, _, tp = _pair("mixtral-8x22b")
    loop = PagedServeLoop(tm, tp, max_batch=2, num_blocks=16, block_size=8,
                          chunk=16)
    loop.submit(Request(rid=0, prompt=np.arange(9, dtype=np.int32),
                        max_new=2))
    with pytest.raises(ValueError, match="sliding"):
        loop.tick()


@pytest.mark.parametrize("arch", MOE)
def test_logits_gap_hooks_reach_the_moe_layers(arch):
    """examples/logits_gap.py's readings set chip_smoke.py's MoE logits
    tolerances, so its hooks must reach an MoE model's attention: at
    smoke size on the CPU (the plain versions) the shipped path reads 0
    and the planted faults move the last position's logits."""
    from repro_torch import threefry
    from repro_torch.examples import logits_gap
    tm = build_model(get_smoke_config(arch))
    params = tm.init(threefry.key(0), "cpu")
    batch = {"tokens": torch.as_tensor(_tokens(tm.cfg, 2, 96, seed=1))}
    plain = logits_gap.prefill_logits(tm, params, batch, impl="ref")
    gaps = {}
    for name, kw in (("kernels", {}),
                     ("nudge", {"impl": "ref",
                                "attention": logits_gap.nudge}),
                     ("drop_head", {"attention": logits_gap.drop_head}),
                     ("half_window", {"attention": logits_gap.half_window})):
        got = logits_gap.prefill_logits(tm, params, batch, **kw)
        gaps[name] = float((got - plain).abs().max() / plain.abs().max())
    assert gaps["kernels"] == 0.0, gaps
    assert gaps["drop_head"] > 0.1 and gaps["half_window"] > 0.1, gaps

"""The port's optimizers and schedules (`repro_torch.optim`) against the JAX
package's (`repro.optim`) on the same numpy inputs from a seed: adamw
(with weight decay) and sgd_momentum (plain and nesterov) over 5 steps on
a mixed bf16 / fp32 tree, through the reference's out-of-place form
(`update` + `apply_updates`) and the port's in-place form (`step_`, piece
by piece, in row chunks); `clip_by_global_norm` below and above its
norm; the three schedules; `opt_state_defs`.

Every operation is elementwise fp32 in the reference's order, so the
moments are held within 1e-6 relative to the leaf's scale (the bias
corrections' powers may round apart by an ulp between XLA and torch) and
the bf16 params to within one bf16 ulp of JAX's, most of them equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import optim as jopt
from repro.configs import get_smoke_config as jax_smoke
from repro.models import build_model as jax_build
from repro_torch import optim as topt
from repro_torch.configs import get_smoke_config
from repro_torch.models import build_model
from repro_torch.models.param import from_reference, is_def, pdef
from repro_torch.optim import optimizers
from repro_torch.tree import leaves, tree_map

STEPS = 5
# (shape, dtype) leaves of the tree: bf16 matrices and a stacked leaf,
# fp32 vectors (the LMs' a_log / d_skip, the CNNs' params)
TREE = {"w": ((6, 40), "bfloat16"), "stack": ((3, 5, 7), "bfloat16"),
        "b": ((40,), "float32"), "s": {"a_log": ((9, 4), "float32")}}
MOMENT_RTOL = 1e-6


def _np_tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    out = {}
    for k in sorted(TREE):
        v = TREE[k]
        if isinstance(v, dict):
            out[k] = {kk: (rng.normal(size=s) * scale).astype(np.float32)
                      for kk, (s, _) in sorted(v.items())}
        else:
            out[k] = (rng.normal(size=v[0]) * scale).astype(np.float32)
    return out


def _dtypes():
    return {k: ({kk: d for kk, (_, d) in v.items()} if isinstance(v, dict)
                else v[1]) for k, v in TREE.items()}


def _jax_tree(t):
    return jax.tree.map(lambda a, d: jnp.asarray(a, jnp.dtype(d)), t,
                        _dtypes())


def _torch_tree(t):
    return tree_map(lambda a, d: torch.from_numpy(a).to(getattr(torch, d)),
                    t, _dtypes())


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _hold_params(jp, tp):
    """bf16 leaves within one bf16 ulp of JAX's (most equal), fp32 leaves
    within 1e-6 relative."""
    for a, b in zip(jax.tree.leaves(jp), leaves(tp)):
        a32, b32 = _f32(a), _f32(b)
        if b.dtype == torch.bfloat16:
            ulp = np.abs(a32) * 2.0 ** -7 + 1e-30
            assert (np.abs(a32 - b32) <= ulp).all()
            assert (a32 == b32).mean() >= 0.99
        else:
            np.testing.assert_allclose(b32, a32, rtol=MOMENT_RTOL,
                                       atol=MOMENT_RTOL * np.abs(a32).max())


def _hold_state(js, ts):
    assert int(np.asarray(js["count"])) == int(ts["count"])
    assert ts["count"].dtype == torch.int32
    for k in js:
        if k == "count":
            continue
        for a, b in zip(jax.tree.leaves(js[k]), leaves(ts[k])):
            assert b.dtype == torch.float32
            a32 = _f32(a)
            np.testing.assert_allclose(_f32(b), a32, rtol=MOMENT_RTOL,
                                       atol=MOMENT_RTOL * np.abs(a32).max())


OPTS = {
    "adamw_wd": (lambda lr: jopt.adamw(lr, weight_decay=0.1),
                 lambda lr: topt.adamw(lr, weight_decay=0.1)),
    "adamw": (lambda lr: jopt.adamw(lr), lambda lr: topt.adamw(lr)),
    "sgd": (lambda lr: jopt.sgd_momentum(lr),
            lambda lr: topt.sgd_momentum(lr)),
    "sgd_nesterov": (lambda lr: jopt.sgd_momentum(lr, nesterov=True),
                     lambda lr: topt.sgd_momentum(lr, nesterov=True)),
}


def _schedule_pair(kind):
    if kind == "constant":
        return jopt.constant(3e-2), topt.constant(3e-2)
    return jopt.cosine_warmup(3e-2, 2, STEPS), \
        topt.cosine_warmup(3e-2, 2, STEPS)


@pytest.mark.parametrize("schedule", ["constant", "cosine"])
@pytest.mark.parametrize("name", sorted(OPTS))
@pytest.mark.parametrize("form", ["update", "step_"])
def test_optimizer_matches_jax_over_five_steps(name, form, schedule,
                                               monkeypatch):
    """5 steps, a new gradient each (one seed a step, clipped by the
    reference's clip at 1.0 so the clip is held too), from the same
    params, against the reference's update + apply_updates."""
    if form == "step_":     # walk every leaf in row chunks of 64 values
        monkeypatch.setattr(optimizers, "CHUNK", 64)
    jlr, tlr = _schedule_pair(schedule)
    jo, to = OPTS[name][0](jlr), OPTS[name][1](tlr)
    jp, tp = _jax_tree(_np_tree(0, 0.5)), _torch_tree(_np_tree(0, 0.5))
    js, ts = jo.init(jp), to.init(tp)
    jstep = jax.jit(lambda p, s, g: _jax_step(jo, p, s, g))
    for k in range(STEPS):
        g = _np_tree(100 + k, 0.3)
        jp, js = jstep(jp, js, _jax_tree(g))
        tg = _torch_tree(g)
        if form == "update":
            clipped, _ = topt.clip_by_global_norm(tg, 1.0)
            upd, ts = to.update(clipped, ts, tp)
            tp = topt.apply_updates(tp, upd)
        else:
            scale = optimizers.clip_scale(topt.global_norm(tg), 1.0)
            moments = [leaves(ts[m]) for m in optimizers.moment_names(ts)]
            to.step_(zip(leaves(tp), leaves(tg), *moments), ts,
                     grad_scale=scale)
    _hold_params(jp, tp)
    _hold_state(js, ts)


def _jax_step(opt, params, state, grads):
    grads, _ = jopt.clip_by_global_norm(grads, 1.0)
    updates, state = opt.update(grads, state, params)
    return jopt.apply_updates(params, updates), state


@pytest.mark.parametrize("scale", [0.01, 10.0], ids=["below", "above"])
def test_clip_by_global_norm_matches_jax(scale):
    g = _np_tree(7, scale)
    jc, jn = jopt.clip_by_global_norm(_jax_tree(g), 1.0)
    tc, tn = topt.clip_by_global_norm(_torch_tree(g), 1.0)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    assert (float(tn) < 1.0) == (scale < 1)
    for a, b in zip(jax.tree.leaves(jc), leaves(tc)):
        assert b.dtype == torch.float32
        np.testing.assert_allclose(_f32(b), _f32(a), rtol=1e-6, atol=1e-7)
    if scale < 1:   # below the norm: the leaves unchanged (in fp32)
        for a, b in zip(leaves(_torch_tree(g)), leaves(tc)):
            assert torch.equal(a.float(), b)
    np.testing.assert_allclose(float(topt.global_norm(tc)),
                               min(float(tn), 1.0), rtol=1e-6)


@pytest.mark.parametrize("kind", ["constant", "linear_warmup",
                                  "cosine_warmup"])
def test_schedules_match_jax(kind):
    warmup, total = 10, 40
    make = {"constant": lambda m: m.constant(3e-3),
            "linear_warmup": lambda m: m.linear_warmup(3e-3, warmup),
            "cosine_warmup": lambda m: m.cosine_warmup(3e-3, warmup, total)}
    jf, tf = make[kind](jopt), make[kind](topt)
    for s in (0, 1, warmup, total, total + 5):
        want = np.float32(jf(jnp.asarray(s, jnp.int32)))
        got = tf(torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                   atol=1e-12)


@pytest.mark.parametrize("name", ["adamw", "sgd"])
@pytest.mark.parametrize("arch", ["qwen1.5-4b", "falcon-mamba-7b",
                                  "flight-cnn-mnist"])
def test_opt_state_defs_match_jax(arch, name):
    jd = jopt.opt_state_defs(jax_build(jax_smoke(arch)).param_defs(), name)
    td = topt.opt_state_defs(build_model(get_smoke_config(arch))
                             .param_defs(), name)
    assert sorted(jd) == sorted(td)
    from repro.models.param import is_def as jax_is_def
    jl = jax.tree.leaves(jd, is_leaf=jax_is_def)
    tl = leaves(td)
    assert len(jl) == len(tl) and all(is_def(d) for d in tl)
    for a, b in zip(jl, tl):
        assert a.shape == b.shape
        assert str(jnp.dtype(a.dtype)) == str(b.dtype).split(".")[-1]
        assert (a.init, a.logical_axes, a.fan_in_axes) == \
            (b.init, b.logical_axes, b.fan_in_axes)
    assert not is_def(np.zeros(3)) and is_def(pdef((2,), (None,)))


def test_optimizer_state_crosses_from_jax():
    """The reference's adamw state after 3 steps, carried over leaf for
    leaf by from_reference, continues in the port as in the reference."""
    jo, to = jopt.adamw(1e-2), topt.adamw(1e-2)
    jp = _jax_tree(_np_tree(0, 0.5))
    js = jo.init(jp)
    jstep = jax.jit(lambda p, s, g: _jax_step(jo, p, s, g))
    for k in range(3):
        jp, js = jstep(jp, js, _jax_tree(_np_tree(100 + k, 0.3)))
    tp = from_reference(jax.tree.map(np.asarray, jp))
    ts = from_reference(jax.tree.map(np.asarray, js))
    assert ts["count"].dtype == torch.int32 and int(ts["count"]) == 3
    g = _np_tree(200, 0.3)
    jp, js = jstep(jp, js, _jax_tree(g))
    tg = _torch_tree(g)
    clipped, _ = topt.clip_by_global_norm(tg, 1.0)
    upd, ts = to.update(clipped, ts, tp)
    tp = topt.apply_updates(tp, upd)
    _hold_params(jp, tp)
    _hold_state(js, ts)

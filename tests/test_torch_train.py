"""The port's training path against the JAX package's, at smoke sizes, on
the same numpy inputs from a seed (params carried across with
`from_reference`):

  * `make_train_step` on the ten assigned archs and both flight CNNs,
    2 steps of adamw (lr 1e-2, clip 1.0) from the same params and batch,
    against `jax.jit(make_train_step(...))`; with grad_accum = 2; remat
    on against remat off in the port;
  * `ssm._chunked_linear_scan` against the reference's, in value and in
    gradient, and at a T the reference cannot take;
  * `make_fl_train_step` at P = 2 against the reference's vmapped step;
  * `launch/train.py` against `repro.launch.train.main` on smoke
    granite-20b under four exchange configs, checkpoints crossing between
    the two launchers both ways, and the loss going down over 12 steps.

What is held after 2 steps, and why.  The readings (PERF.md section 6):
`python tests/test_torch_train.py` prints the port-vs-JAX gaps of every
arch; `python -m repro_torch.examples.train_gap --device cpu --arch all`
the port's own gaps under a one-ulp nudge of every param and under
planted faults.  Each tolerance (`train_gap.TOL`) lies above the
largest port-vs-JAX reading and below the planted faults it is there to
catch:

  * loss, xent, aux and grad_norm, relative to JAX's: metric_step1 at step
    1 (readings up to 3.0e-3, phi-3-vision; a loss mask one position
    off reads 4.4e-3 to 1.8e-2 over two steps) and metric_step2 at step 2
    (readings up to 4.6e-3, the MoE archs, whose routing parts at near
    ties), after adamw's first, sign-like update has amplified them;
  * adamw's moments mu and nu, the tree's rms gap relative to its rms:
    moments (readings up to 0.045; the mask fault reads 0.15-0.23, a
    dropped clip 0.22-2.1), moe_moments for the MoE archs (readings
    up to 0.096).  Linear and quadratic in the clipped gradients, the
    moments hold the gradient of every leaf, the clip and the loss mask;
  * the params: the tree's rms gap relative to its update within
    update_tree (readings up to 0.123; a one-ulp nudge of every param
    reads 0.20-0.28, not updating reads 1.0) and every leaf updated in
    JAX's direction (the regression slope of the port's update on JAX's
    at least slope_min; readings down to 0.35, chatglm3's key bias,
    whose gradient is rounding noise).  Adam's second update divides by
    the moments, so a weight whose two gradients nearly cancel moves by
    O(lr) under any rounding: the params alone cannot tell a rounding
    from a fault, and adamw's bias correction is held exactly by
    tests/test_torch_optim.py.

The fp32 CNNs round apart by 1e-5 at most and take `train_gap.TOL_FP32`
(1e-4 on the metrics, 1e-3 on the moments, 2e-3 on the params' tree),
under which adamw's bias correction one count ahead (0.22-0.27 in the
params) is caught too.
"""
import contextlib
import dataclasses
import io
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke_config as jax_smoke
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.models import build_model as jax_build
from repro.models import ssm as jax_ssm
from repro.optim import adamw as jax_adamw
from repro_torch import threefry
from repro_torch.configs import get_smoke_config, list_archs
from repro_torch.examples import train_gap
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.linrec import ops as linrec_ops
from repro_torch.launch import steps
from repro_torch.launch import train as ttrain
from repro_torch.models import build_model, ssm
from repro_torch.models.param import from_reference
from repro_torch.optim import adamw
from repro_torch.tree import leaves, tree_map

ARCHS = list_archs()           # the ten assigned archs and the two CNNs
B, T, LR = 2, 32, 1e-2
METRIC_TOL = train_gap.TOL["metric_step1"]
LAUNCH_LOSS_TOL = 1e-3
LAUNCH = ["--arch", "granite-20b", "--smoke", "--steps", "4", "--islands",
          "2", "--local-steps", "2", "--batch", "4", "--seq", "32"]
LAUNCH_CASES = {"none": [], "q8_fog": ["--compress", "q8", "--fog-cells",
                                       "2"],
                "q8topk_robust_byz": ["--compress", "q8-topk",
                                      "--robust-agg", "trimmed_mean",
                                      "--byzantine", "0.5"],
                "overlap": ["--compress", "q8", "--overlap"]}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """A smoke step is thousands of tiny ops, which one intra-op thread
    runs fastest (beside other test workers, a pool of eight took 3-30x
    longer); the module's setting is restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, **kw):
    return (dataclasses.replace(jax_smoke(arch), **kw),
            dataclasses.replace(get_smoke_config(arch), **kw))


def _inputs(tm, batch_np):
    jb = {k: jnp.asarray(v, jnp.int32 if v.dtype == np.int32 else
                         (jnp.float32 if tm.cfg.family == "cnn"
                          else jnp.bfloat16))
          for k, v in batch_np.items()}
    return jb, train_gap.to_torch(batch_np, tm, "cpu")


def step_pair(arch, n=2, batch=B, **kw):
    """n steps of the reference's jitted step and of the port's, from the
    same params and batch -> (initial torch params, (jax params, state,
    [metrics]), (torch params, state, [metrics]))."""
    jc, tc = _cfgs(arch, **kw)
    jm, tm = jax_build(jc), build_model(tc)
    jp = jm.init(jax.random.key(0))
    tp = from_reference(jax.tree.map(np.asarray, jp))
    p0 = tree_map(torch.clone, tp)
    jb, tb = _inputs(tm, train_gap.train_batch(tm, batch, T))
    jo, to = jax_adamw(LR), adamw(LR)
    jstep = jax.jit(jsteps.make_train_step(jm, jo))
    tstep = steps.make_train_step(tm, to)
    js, ts = jo.init(jp), to.init(tp)
    jms, tms = [], []
    for _ in range(n):
        jp, js, jm_ = jstep(jp, js, jb)
        tp, ts, tm_ = tstep(tp, ts, tb)
        jms.append({k: float(v) for k, v in jm_.items()})
        tms.append({k: float(v) for k, v in tm_.items()})
    return p0, (jp, js, jms), (tp, ts, tms)


def gaps(p0, j, t) -> dict:
    """train_gap's readings of the port's run against the reference's."""
    jp, js, jms = j
    want = (from_reference(jax.tree.map(np.asarray, jp)),
            from_reference(jax.tree.map(np.asarray, js)), jms)
    return train_gap.gaps(p0, want, t)


def _hold(arch, g):
    assert train_gap.violations(get_smoke_config(arch), g) == [], g


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch):
    g = gaps(*step_pair(arch))
    _hold(arch, g)


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "flight-cnn-mnist"])
def test_grad_accum_matches_jax(arch):
    g = gaps(*step_pair(arch, batch=2 * B, grad_accum=2))
    _hold(arch, g)


@pytest.mark.parametrize("arch", ["granite-20b", "mixtral-8x22b",
                                  "falcon-mamba-7b", "recurrentgemma-9b",
                                  "phi-3-vision-4.2b",
                                  "seamless-m4t-large-v2"])
def test_remat_equals_no_remat(arch):
    """Checkpointed layers recompute the same values: the step with remat
    equals the step without, bit for bit, on the CPU."""
    out = []
    for remat in (False, True):
        tm = build_model(dataclasses.replace(get_smoke_config(arch),
                                             remat=remat))
        tp = tm.init(threefry.key(0),
                     "cpu")
        tb = train_gap.to_torch(train_gap.train_batch(tm, B, T), tm, "cpu")
        opt = adamw(LR)
        st = opt.init(tp)
        step = steps.make_train_step(tm, opt)
        for _ in range(2):
            tp, st, m = step(tp, st, tb)
        out.append((tp, st, m))
    (pa, sa, ma), (pb, sb, mb) = out
    assert all(torch.equal(a, b) for a, b in zip(leaves(pa), leaves(pb)))
    assert all(torch.equal(a, b) for a, b in zip(leaves(sa), leaves(sb)))
    assert all(torch.equal(ma[k], mb[k]) for k in ma)


def test_remat_checkpoints_each_layer(monkeypatch):
    """With remat and a gradient, every layer runs under checkpoint; with
    no gradient (a prefill) none does."""
    from torch.utils.checkpoint import checkpoint as real
    calls = []

    def counting(fn, *a, **kw):
        calls.append(fn.__name__)
        return real(fn, *a, **kw)

    from repro_torch.models import layers
    monkeypatch.setattr(layers, "checkpoint", counting)
    cfg = dataclasses.replace(get_smoke_config("granite-20b"), remat=True)
    tm = build_model(cfg)
    tp = tm.init(threefry.key(0), "cpu")
    tb = train_gap.to_torch(train_gap.train_batch(tm, B, T), tm, "cpu")
    steps.make_train_step(tm, adamw(LR))(tp, adamw(LR).init(tp), tb)
    assert calls == ["_block_apply"] * cfg.num_layers
    calls.clear()
    steps.make_prefill_step(tm)(tp, {"tokens": tb["tokens"]})
    assert calls == []


@pytest.mark.parametrize("arch", ["granite-20b", "falcon-mamba-7b",
                                  "recurrentgemma-9b",
                                  "seamless-m4t-large-v2"])
def test_train_step_takes_no_kernel_op(arch, monkeypatch):
    """The gradient route is chosen before a kernel op: with both kernel
    ops made to fail, the train step runs; a prefill reaches them."""
    def boom(*a, **kw):
        raise AssertionError("a kernel op in a train step")

    tm = build_model(get_smoke_config(arch))
    tp = tm.init(threefry.key(0), "cpu")
    tb = train_gap.to_torch(train_gap.train_batch(tm, B, T), tm, "cpu")
    monkeypatch.setattr(flash_ops, "flash_attention", boom)
    monkeypatch.setattr(linrec_ops, "linrec", boom)
    _, _, m = steps.make_train_step(tm, adamw(LR))(tp, adamw(LR).init(tp),
                                                   tb)
    assert np.isfinite(float(m["loss"]))
    with pytest.raises(AssertionError, match="kernel op"):
        steps.make_prefill_step(tm)(tp, {k: v for k, v in tb.items()
                                         if k != "labels"})


@pytest.mark.parametrize("T_", [32, 77])
def test_chunked_linear_scan_matches_jax(T_):
    """Value and gradient of the ported scan against the reference's, on
    (B, T, D, N) fp32; T = 77 with chunks of 16 is a length the reference
    refuses (T % chunk), held against its chunk-1 form."""
    rng = np.random.default_rng(3)
    a = rng.uniform(0.5, 1.0, (2, T_, 3, 4)).astype(np.float32)
    b = rng.normal(size=(2, T_, 3, 4)).astype(np.float32)
    h0 = rng.normal(size=(2, 3, 4)).astype(np.float32)
    w = rng.normal(size=(2, T_, 3, 4)).astype(np.float32)
    chunk = 16
    jchunk = chunk if T_ % chunk == 0 else 1

    def jloss(a, b, h0):
        ys, hT = jax_ssm._chunked_linear_scan(a, b, h0, jchunk)
        return jnp.sum(ys * w) + jnp.sum(hT)

    jv, jg = jax.value_and_grad(jloss, argnums=(0, 1, 2))(a, b, h0)
    ta, tb, th = (torch.from_numpy(x).requires_grad_() for x in (a, b, h0))
    ys, hT = ssm._chunked_linear_scan(ta, tb, th, chunk)
    tv = (ys * torch.from_numpy(w)).sum() + hT.sum()
    tg = torch.autograd.grad(tv, (ta, tb, th))
    ys_j, hT_j = jax_ssm._chunked_linear_scan(a, b, h0, jchunk)
    np.testing.assert_allclose(ys.detach().numpy(), np.asarray(ys_j),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(hT.detach().numpy(), np.asarray(hT_j),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-5)
    for x, y in zip(tg, jg):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-4,
                                   atol=1e-4)


def test_fl_train_step_matches_vmapped_jax():
    """P = 2 islands, each its own params (the second nudged) and batch:
    the port's loop over islands against the reference's vmap; each
    island's result equals the single step's on it."""
    P = 2
    jm, tm = jax_build(jax_smoke("qwen1.5-4b")), \
        build_model(get_smoke_config("qwen1.5-4b"))
    jp = jm.init(jax.random.key(0))
    jp = jax.tree.map(lambda l: jnp.stack([l, l * 1.01]).astype(l.dtype), jp)
    tp = from_reference(jax.tree.map(np.asarray, jp))
    bs = [train_gap.train_batch(tm, B, T, seed=s) for s in range(P)]
    bnp = {k: np.stack([b[k] for b in bs]) for k in bs[0]}
    jb = {k: jnp.asarray(v) for k, v in bnp.items()}
    tb = {k: torch.from_numpy(v) for k, v in bnp.items()}
    jo, to = jax_adamw(LR), adamw(LR)
    jstep = jax.jit(jsteps.make_fl_train_step(jm, jo, P))
    js = jax.vmap(jo.init)(jp)
    ts = {"mu": tree_map(lambda l: torch.zeros(l.shape), tp),
          "nu": tree_map(lambda l: torch.zeros(l.shape), tp),
          "count": torch.zeros(P, dtype=torch.int32)}
    single = [tree_map(lambda l: l[i].clone(), tp) for i in range(P)]
    tp, ts, tmet = steps.make_fl_train_step(tm, to, P)(tp, ts, tb)
    jp, js, jmet = jstep(jp, js, jb)
    assert tmet["loss"].shape == (P,)
    np.testing.assert_allclose(tmet["loss"].numpy(), np.asarray(jmet["loss"]),
                               rtol=METRIC_TOL)
    np.testing.assert_allclose(tmet["grad_norm"].numpy(),
                               np.asarray(jmet["grad_norm"]), rtol=METRIC_TOL)
    assert ts["count"].tolist() == [1, 1]
    one = steps.make_train_step(tm, adamw(LR))
    for i in range(P):
        sp, _, sm = one(single[i], adamw(LR).init(single[i]),
                        {k: v[i] for k, v in tb.items()})
        assert float(sm["loss"]) == float(tmet["loss"][i])
        assert all(torch.equal(a, b[i]) for a, b in zip(leaves(sp),
                                                        leaves(tp)))


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue().splitlines()


def _parse(lines):
    """[(step, loss, tag)] of the [train] step lines (the ms apart)."""
    out = []
    for ln in lines:
        if ln.startswith("[train] step="):
            f = ln.split()
            out.append((f[1], float(f[2].split("=")[1]),
                        " ".join(f[4:])))
    return out


def _hold_runs(jl, tl):
    j, t = _parse(jl), _parse(tl)
    assert [(s, tag) for s, _, tag in j] == [(s, tag) for s, _, tag in t]
    for (_, a, _), (_, b, _) in zip(j, t):
        assert abs(a - b) <= LAUNCH_LOSS_TOL * abs(a), (j, t)
    assert [ln for ln in jl if not ln.startswith("[train] step=")] == \
        [ln for ln in tl if not ln.startswith("[train] step=")]


@pytest.mark.parametrize("case", sorted(LAUNCH_CASES))
def test_launcher_matches_jax(case):
    argv = LAUNCH + LAUNCH_CASES[case]
    jl = _run(jtrain.main, argv)
    tl = _run(ttrain.main, argv + ["--device", "cpu"])
    assert len(_parse(tl)) == 4
    _hold_runs(jl, tl)


@pytest.mark.parametrize("first", ["jax", "port"])
def test_checkpoint_resumes_across_packages(first, tmp_path):
    """One package runs 4 steps, checkpointing at steps 2 and 4; the other
    resumes from the step-2 checkpoint (step 4's removed, as if the run
    had been killed before it): its steps 3-4 equal the first run's in
    lines and tags, losses within LAUNCH_LOSS_TOL."""
    mains = {"jax": (jtrain.main, []),
             "port": (ttrain.main, ["--device", "cpu"])}
    second = "port" if first == "jax" else "jax"
    ck = ["--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    m, extra = mains[first]
    whole = _run(m, LAUNCH + ck + extra)
    shutil.rmtree(tmp_path / f"step_{4:010d}")
    m, extra = mains[second]
    resumed = _run(m, LAUNCH + ck + ["--resume"] + extra)
    assert "[train] resumed from step 2" in resumed
    r = [ln for ln in resumed if ln.startswith("[train] step=")]
    w = [ln for ln in whole if ln.split()[1:2] in (["step=3"], ["step=4"])]
    assert [ln.split()[1] for ln in r] == ["step=3", "step=4"]
    _hold_runs(w, r)


def test_launcher_loss_goes_down():
    """tests/test_robust_agg.py's convergence gate, on the port: 12 steps
    of q8-topk + trimmed mean through real exchanges."""
    lines = _run(ttrain.main, ["--arch", "granite-20b", "--smoke",
                               "--steps", "12", "--islands", "2",
                               "--local-steps", "2", "--batch", "4",
                               "--seq", "32", "--compress", "q8-topk",
                               "--robust-agg", "trimmed_mean", "--seed", "0",
                               "--device", "cpu"])
    losses = [loss for _, loss, _ in _parse(lines)]
    assert len(losses) == 12
    assert any("robust-exchange:trimmed_mean+q8-topk" in ln for ln in lines)
    assert losses[-1] < losses[0], losses


def test_launcher_islands_agree_after_an_exchange():
    """tests/test_system.py's consensus check on the port's launcher: after
    the last q8 exchange every island holds the same params."""
    res = ttrain.main(LAUNCH + ["--compress", "q8", "--device", "cpu"])
    assert res["tags"] == ["local", "exchange+q8", "local", "exchange+q8"]
    for leaf in leaves(res["params"]):
        assert torch.equal(leaf[0], leaf[1])


@pytest.mark.parametrize("arch,fault", [
    ("qwen1.5-4b", "no_clip"), ("qwen1.5-4b", "bias_corr"),
    ("qwen1.5-4b", "mask_shift"), ("flight-cnn-cifar", "no_clip"),
    ("flight-cnn-cifar", "bias_corr")])
def test_planted_faults_break_the_tolerance(arch, fault):
    """The tolerances the port is held to catch examples/train_gap.py's
    planted faults (its readings set them): a dropped clip, adamw's bias
    correction one count ahead, a loss mask one position longer."""
    tm = build_model(get_smoke_config(arch))
    tp = tm.init(threefry.key(0), "cpu")
    tb = train_gap.to_torch(train_gap.train_batch(tm, B, T), tm, "cpu")
    plain = train_gap.run_steps(tm, tp, tb)
    kw = {"no_clip": {"clip_norm": float("inf")},
          "bias_corr": {"count0": 1}}.get(fault, {})
    with (train_gap.mask_shift() if fault == "mask_shift"
          else contextlib.nullcontext()):
        faulty = train_gap.run_steps(tm, tp, tb, **kw)
    assert train_gap.violations(tm.cfg, train_gap.gaps(tp, plain,
                                                       faulty)) != []
    assert train_gap.violations(tm.cfg, train_gap.gaps(tp, plain,
                                                       plain)) == []


def test_train_lm_federated_example_runs(tmp_path):
    """The example trains its custom config (6 layers, d_model 256)
    through launch/train.py's main(cfg=), on two islands."""
    from repro_torch.examples import train_lm_federated
    res = train_lm_federated.main(["--device", "cpu", "--steps", "1",
                                   "--ckpt-dir", str(tmp_path)])
    assert res["tags"] == ["local"]
    assert leaves(res["params"]["layers"])[0].shape[:2] == (2, 6)
    assert all(np.isfinite(res["losses"]))

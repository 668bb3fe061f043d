"""The port's flash attention (kernels/flash_attention) against the JAX
package on the same numpy inputs: its plain version against JAX's
`attention_ref` and the model's `attention_full` over tests/test_kernels.py's
sweep plus odd lengths, small head dims and non-causal attention, and
against the Pallas `flash_attention_bhtd` in interpret mode on two shapes.
Tolerances are test_kernels.py's: 3e-4 fp32, 3e-2 bf16.  The CUDA kernel's
own tests, which need the card, are in test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention import ops as jops
from repro.kernels.flash_attention.kernel import flash_attention_bhtd
from repro.kernels.flash_attention.ref import attention_ref as jref
from repro.models import layers as jlayers
from repro_torch.kernels.flash_attention import kernel as tkernel
from repro_torch.kernels.flash_attention import ops as tops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models.param import from_reference

DTYPES = {"float32": (jnp.float32, 3e-4), "bfloat16": (jnp.bfloat16, 3e-2)}

# test_kernels.py's sweep (T, H, Hkv, D, window), then odd T, small D,
# MQA with the granite group size
SWEEP = [
    (256, 4, 4, 64, 0),      # MHA causal
    (256, 4, 2, 64, 0),      # GQA
    (512, 8, 1, 128, 0),     # MQA, D=128
    (512, 4, 2, 64, 128),    # sliding window
    (1024, 2, 2, 64, 300),   # window not block-aligned
    (1, 4, 1, 8, 0),         # one token
    (77, 4, 2, 12, 0),       # odd T, D=12 (qwen1.5 smoke)
    (1000, 2, 1, 16, 0),     # T=1000, D=16 (granite smoke)
    (77, 8, 2, 8, 5),        # D=8 (chatglm3 smoke), short window
    (65, 48, 1, 16, 0),      # G=48 (granite-20b's MQA group)
]


def _qkv(B, T, H, Hkv, D, dtype, seed=0):
    rng = np.random.default_rng(seed + T * 31 + H * 7 + D)
    jdt, _ = DTYPES[dtype]
    q = jnp.asarray(rng.normal(size=(B, T, H, D)) * 0.3, jdt)
    k = jnp.asarray(rng.normal(size=(B, T, Hkv, D)) * 0.3, jdt)
    v = jnp.asarray(rng.normal(size=(B, T, Hkv, D)), jdt)
    return (q, k, v), tuple(from_reference(np.asarray(a)) for a in (q, k, v))


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("T,H,Hkv,D,window", SWEEP)
def test_plain_version_matches_jax_ref(T, H, Hkv, D, window, dtype):
    (q, k, v), (qt, kt, vt) = _qkv(2, T, H, Hkv, D, dtype)
    tol = DTYPES[dtype][1]
    want = jops.flash_attention(q, k, v, causal=True, window=window,
                                impl="ref")
    got = tops.flash_attention(qt, kt, vt, causal=True, window=window)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    _close(got, want, tol)
    # the model's exact path (probs cast to bf16 before PV in bf16)
    _close(got, jlayers.attention_full(q, k, v, causal=True, window=window),
           tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("T,H,Hkv,D", [(77, 4, 2, 16), (256, 4, 1, 64)])
def test_non_causal_matches_jax_ref(T, H, Hkv, D, dtype):
    (q, k, v), (qt, kt, vt) = _qkv(1, T, H, Hkv, D, dtype, seed=5)
    want = jref(*(a.transpose(0, 2, 1, 3) for a in (q, k, v)),
                causal=False).transpose(0, 2, 1, 3)
    _close(tops.flash_attention(qt, kt, vt, causal=False), want,
           DTYPES[dtype][1])
    # ref.py itself, in the kernel's BHTD layout
    got = attention_ref(*(t.transpose(1, 2) for t in (qt, kt, vt)),
                        causal=False).transpose(1, 2)
    _close(got, want, DTYPES[dtype][1])


@pytest.mark.parametrize("dtype,window", [("float32", 0),
                                          ("bfloat16", 128)])
def test_plain_version_matches_pallas_interpret(dtype, window):
    """The Pallas kernel itself, as test_kernels.py runs it on the CPU."""
    (q, k, v), (qt, kt, vt) = _qkv(1, 256, 4, 2, 64, dtype, seed=9)
    want = flash_attention_bhtd(*(a.transpose(0, 2, 1, 3) for a in (q, k, v)),
                                causal=True, window=window, bq=128, bk=128,
                                interpret=True).transpose(0, 2, 1, 3)
    _close(tops.flash_attention(qt, kt, vt, window=window), want,
           DTYPES[dtype][1])


def test_impl_ref_and_bad_impl():
    _, (qt, kt, vt) = _qkv(1, 9, 2, 1, 8, "float32")
    a = tops.flash_attention(qt, kt, vt, impl="ref")
    b = tops.flash_attention(qt, kt, vt)
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="impl"):
        tops.flash_attention(qt, kt, vt, impl="pallas")


def test_gradient_request_raises():
    _, (qt, kt, vt) = _qkv(1, 9, 2, 1, 8, "float32")
    qt.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="backward"):
        tops.flash_attention(qt, kt, vt)
    with torch.no_grad():
        tops.flash_attention(qt, kt, vt)


def test_cuda_wrapper_rejects_what_the_kernel_does_not_take():
    """The checks run before any build or launch, so they hold here."""
    _, (qt, kt, vt) = _qkv(1, 9, 2, 1, 8, "float32")
    before = tkernel.flash_attention_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.flash_attention_cuda(qt, kt, vt)
    meta = {"device": "meta"}
    q = torch.empty(1, 9, 4, 8, **meta)
    k = torch.empty(1, 9, 2, 8, **meta)
    checks = [
        ((q, k[:, :5], k[:, :5]), ValueError, "S = 5"),
        ((q, torch.empty(1, 9, 3, 8, **meta),
          torch.empty(1, 9, 3, 8, **meta)), ValueError, "multiple"),
        ((torch.empty(1, 9, 2, 300, **meta),) + (torch.empty(
            1, 9, 1, 300, **meta),) * 2, ValueError, "head dim"),
        ((q.half(), k.half(), k.half()), TypeError, "dtypes"),
        ((q, k, k.bfloat16()), TypeError, "dtypes"),
        ((torch.empty(1, 9, 4, 16, **meta)[..., ::2], k, k), ValueError,
         "contiguous"),
    ]
    for args, exc, match in checks:
        with pytest.raises(exc, match=match):
            tkernel.check_inputs(*args)
    tkernel.check_inputs(q.transpose(1, 2).contiguous().transpose(1, 2),
                         k, k)     # any batch/time/head strides
    assert tkernel.flash_attention_cuda.launches == before


def _meta(B, T, H, Hkv, D, dtype=torch.bfloat16):
    meta = {"device": "meta", "dtype": dtype}
    return (torch.empty(B, T, H, D, **meta), torch.empty(B, T, Hkv, D, **meta),
            torch.empty(B, T, Hkv, D, **meta))


@pytest.mark.parametrize("arch,B", [("granite-20b", 8),
                                    ("recurrentgemma-9b", 2)])
def test_route_full_width_prefills_take_wgmma(arch, B):
    """Both models' full-width prefill attention (bf16, head dims 128 and
    256) is TMA-describable: flash_fwd_wgmma."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    qkv = _meta(B, 2048, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
    assert tkernel.route(*qkv) == "wgmma"


def test_route_smoke_configs():
    """Every smoke config with attention: bf16 heads whose D is a multiple
    of 8 take wgmma; qwen1.5-4b's D = 12 takes mma."""
    from repro_torch.configs import get_smoke_config, list_archs
    seen = {}
    for arch in list_archs():
        cfg = get_smoke_config(arch)
        if cfg.num_heads == 0:
            continue
        qkv = _meta(2, 37, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
        seen[arch] = (cfg.head_dim, tkernel.route(*qkv))
    assert seen["qwen1.5-4b"] == (12, "mma")
    for arch in ("granite-20b", "chatglm3-6b", "minitron-8b",
                 "recurrentgemma-9b"):
        assert seen[arch][1] == "wgmma", (arch, seen[arch])
    for D, name in seen.values():
        assert name == ("wgmma" if D % 8 == 0 else "mma")


def test_route_other_layouts():
    """What TMA cannot describe keeps the older kernels: D not a multiple
    of 8 (mma up to 128), an odd head stride at D = 200 (fma), a base off
    16 bytes, a zero stride; fp32 always takes fma."""
    assert tkernel.route(*_meta(1, 9, 4, 2, 12)) == "mma"
    assert tkernel.route(*_meta(1, 9, 4, 2, 200)) == "wgmma"
    wide = torch.empty(1, 9, 4, 201, device="meta", dtype=torch.bfloat16)
    q = wide[..., :200]
    assert q.stride(2) == 201
    assert tkernel.route(q, q[:, :, :2], q[:, :, :2]) == "fma"
    off = torch.empty(1, 9, 4, 72, device="meta", dtype=torch.bfloat16)
    q = off[..., 4:68]                     # 8 bytes past a 16-byte boundary
    assert tkernel.route(q, q[:, :, :1], q[:, :, :1]) == "mma"
    q = off[..., 8:72]                     # 16 bytes on: aligned
    assert tkernel.route(q, q[:, :, :1], q[:, :, :1]) == "wgmma"
    q, k, v = _meta(1, 9, 4, 1, 64)
    assert tkernel.route(q, k.expand(1, 9, 1, 64).as_strided(
        k.shape, (576, 0, 64, 1)), v) == "mma"
    assert tkernel.route(*_meta(8, 2048, 48, 1, 128, torch.float32)) == "fma"
    assert tkernel.route(*_meta(1, 9, 4, 1, 256, torch.float32)) == "fma"
    # a strided view as a fused projection leaves it: TMA reads it
    qkv = torch.empty(2, 96, 6, 64, device="meta", dtype=torch.bfloat16)
    assert tkernel.route(qkv[:, :, :4], qkv[:, :, 4:5],
                         qkv[:, :, 5:6]) == "wgmma"


def test_kernel_resources_reads_ptxas_report(monkeypatch, tmp_path):
    """examples/kernel_resources.py turns ptxas's -v lines into one record
    per entry function (nvcc itself runs only where the toolkit is)."""
    import subprocess
    from types import SimpleNamespace
    from repro_torch.examples import kernel_resources as kr
    ptxas = "\n".join([
        "ptxas info    : Compiling entry function '_Z3fooPf' for 'sm_90a'",
        "ptxas info    : Function properties for _Z3fooPf",
        "    208 bytes stack frame, 416 bytes spill stores, 400 bytes "
        "spill loads",
        "ptxas info    : Used 168 registers, used 1 barriers, 208 bytes "
        "cumulative stack size",
        "ptxas info    : Compiling entry function '_Z3barv' for 'sm_90a'",
        "ptxas info    : Function properties for _Z3barv",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 32 registers, 4096 bytes smem"])
    calls = []

    def fake_run(cmd, **kw):
        calls.append(cmd)
        return SimpleNamespace(returncode=0, stdout="", stderr=ptxas)

    monkeypatch.setattr(kr, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(kr, "demangle", lambda names: names)
    monkeypatch.setattr(subprocess, "run", fake_run)
    recs = kr.report("flash_attention", tkernel.SOURCES, tmp_path)
    assert "-Xptxas" in calls[0] and str(tkernel.SOURCES[0]) in calls[0]
    assert [(r["entry"], r["registers"], r["spill_stores"], r["spill_loads"],
             r["stack"], r["smem"]) for r in recs] == [
        ("_Z3fooPf", 168, 416, 400, 208, 0), ("_Z3barv", 32, 0, 0, 0, 4096)]


# -- training: the differentiable op, its plain backward, the route -------

def _grads_of(fn, q, k, v, do):
    """d(fn(q, k, v) . do) / d(q, k, v), fp32 leaves made from the inputs'
    values unless they already are leaves."""
    ins = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    out = fn(*ins)
    return out, torch.autograd.grad(out, ins, do.to(out.dtype))


def _rel(got, want):
    got, want = got.detach().float(), want.detach().float()
    return float((got - want).abs().max()
                 / want.abs().max().clamp_min(1e-30))


def _train_inputs(B, T, H, Hkv, D, dtype, seed=0):
    (q, k, v), (qt, kt, vt) = _qkv(B, T, H, Hkv, D, dtype, seed=seed)
    rng = np.random.default_rng(seed + 101)
    do = rng.normal(size=(B, T, H, D)).astype(np.float32)
    jdo = jnp.asarray(do, DTYPES[dtype][0])
    return (q, k, v, jdo), (qt, kt, vt, from_reference(np.asarray(jdo)))


TRAIN_CASES = [(T, H, Hkv, D, window, True)
               for T, H, Hkv, D, window in SWEEP] + [
    (77, 4, 2, 16, 0, False), (256, 4, 1, 64, 0, False)]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("T,H,Hkv,D,window,causal", TRAIN_CASES)
def test_train_op_matches_autograd_of_attention_full(T, H, Hkv, D, window,
                                                     causal, dtype):
    """flash_attention_train on the CPU (ref.py's forward with its lse and
    blockwise backward, the kernels' arithmetic) against torch.autograd of
    the model's attention_full on the same values in fp32: output and the
    three gradients, each within the file's tolerance of the largest
    reference entry."""
    from repro_torch.models.layers import attention_full
    _, (qt, kt, vt, dot) = _train_inputs(2, T, H, Hkv, D, dtype)
    tol = DTYPES[dtype][1]
    out, got = _grads_of(lambda q, k, v: tops.flash_attention_train(
        q, k, v, causal=causal, window=window), qt, kt, vt, dot)
    want_out, want = _grads_of(lambda q, k, v: attention_full(
        q, k, v, causal=causal, window=window),
        *(t.float() for t in (qt, kt, vt)), dot.float())
    assert out.dtype == qt.dtype and out.is_contiguous()
    assert [g.dtype for g in got] == [qt.dtype] * 3
    assert _rel(out, want_out) <= tol
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _rel(g, w) <= tol, (_rel(g, w), tol)


@pytest.mark.parametrize("T,H,Hkv,D,window,causal", TRAIN_CASES)
def test_train_op_matches_jax_grad(T, H, Hkv, D, window, causal):
    """The same gradients against jax.vjp of the JAX package's
    attention_full, fp32, on the same numpy inputs (3e-4 of the largest
    entry)."""
    import jax
    (q, k, v, do), (qt, kt, vt, dot) = _train_inputs(1, T, H, Hkv, D,
                                                     "float32", seed=3)
    _, vjp = jax.vjp(lambda q, k, v: jlayers.attention_full(
        q, k, v, causal=causal, window=window), q, k, v)
    want = vjp(do)
    _, got = _grads_of(lambda q, k, v: tops.flash_attention_train(
        q, k, v, causal=causal, window=window), qt, kt, vt, dot)
    for g, w in zip(got, want):
        np.testing.assert_allclose(
            g.numpy(), np.asarray(w), rtol=0,
            atol=3e-4 * float(np.abs(np.asarray(w)).max()))


@pytest.mark.parametrize("T,window,causal", [(300, 0, True), (200, 70, True),
                                             (130, 0, False)])
def test_bwd_ref_tiling_and_splits(T, window, causal):
    """attention_bwd_ref is one algorithm at every tiling (tiles of 16 to
    128, T no multiple of any, dead tiles skipped): its gradients agree
    across tilings to fp32 round-off, and with P and dS split hi + lo they
    stay within 2^-15 of fp32 products (here: the same backward with the
    splits' lo parts dropped moves them by far more)."""
    from repro_torch.kernels.flash_attention import ref
    _, (qt, kt, vt, dot) = _train_inputs(1, T, 4, 2, 64, "bfloat16", seed=7)
    qh, kh, vh, doh = (t.transpose(1, 2) for t in (qt, kt, vt, dot))
    of, lse = ref.attention_lse_ref(qh, kh, vh, causal=causal, window=window)
    runs = [ref.attention_bwd_ref(qh, kh, vh, of, lse, doh, causal=causal,
                                  window=window, bq=bq, bk=bk)
            for bq, bk in ((64, 64), (16, 32), (128, 64))]
    for other in runs[1:]:
        for a, b in zip(runs[0], other):
            assert _rel(a, b) <= 2 ** -8   # bf16 outputs: one rounding apart
    # the fp32 gradients (no rounding of outputs): splits vs none
    qf, kf, vf, dof = (t.float() for t in (qh, kh, vh, doh))
    split = ref.attention_bwd_ref(qf, kf, vf, of, lse, dof, causal=causal,
                                  window=window)
    orig = ref.split_bf16
    try:
        ref.split_bf16 = lambda x: (x, torch.zeros_like(x))
        exact = ref.attention_bwd_ref(qf, kf, vf, of, lse, dof,
                                      causal=causal, window=window)
        ref.split_bf16 = lambda x: (x.to(torch.bfloat16).float(),
                                    torch.zeros_like(x))
        hi_only = ref.attention_bwd_ref(qf, kf, vf, of, lse, dof,
                                        causal=causal, window=window)
    finally:
        ref.split_bf16 = orig
    for s, e, h in zip(split, exact, hi_only):
        assert _rel(s, e) <= 2 ** -15
        assert _rel(h, e) > 4 * _rel(s, e)


def test_lse_ref_is_the_rows_log_sum_exp():
    """attention_lse_ref's output is attention_ref's before its rounding
    (within one bf16 rounding of it) and its lse is each row's log-sum-exp
    of the masked scaled scores."""
    from repro_torch.kernels.flash_attention import ref
    _, (qt, kt, vt, _) = _train_inputs(2, 77, 4, 2, 16, "bfloat16")
    qh, kh, vh = (t.transpose(1, 2) for t in (qt, kt, vt))
    of, lse = ref.attention_lse_ref(qh, kh, vh, window=20)
    assert of.dtype == torch.float32
    assert _rel(of, attention_ref(qh, kh, vh, window=20)) <= 2 ** -8
    s = torch.einsum("bhtd,bhsd->bhts", qh.float(),
                     kh.float().repeat_interleave(2, 1)) / 4.0
    t = torch.arange(77)
    live = (t[None, :] <= t[:, None]) & (t[None, :] > t[:, None] - 20)
    want = torch.logsumexp(s.masked_fill(~live, -torch.inf), -1)
    torch.testing.assert_close(lse, want, rtol=1e-6, atol=1e-6)


def test_train_op_under_checkpoint_and_same_bits():
    """Inside torch.utils.checkpoint (remat: the forward runs again in the
    backward) the op gives the gradients it gives without, bit for bit, and
    two calls give the same bits."""
    from torch.utils.checkpoint import checkpoint
    _, (qt, kt, vt, dot) = _train_inputs(1, 100, 4, 2, 48, "bfloat16")

    def f(q, k, v):
        return tops.flash_attention_train(q, k, v, window=40)
    _, plain = _grads_of(f, qt, kt, vt, dot)
    _, again = _grads_of(f, qt, kt, vt, dot)
    _, remat = _grads_of(lambda q, k, v: checkpoint(f, q, k, v,
                                                    use_reentrant=False),
                         qt, kt, vt, dot)
    for a, b, c in zip(plain, again, remat):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_train_op_reports_its_work_to_a_walk():
    """On meta tensors the op returns empty outputs and gradients, and a
    cost walk of its forward and backward counts the two formulas."""
    from repro_torch.dist import cost, hardware
    q, k, v = (t.requires_grad_(True) for t in _meta(2, 256, 8, 2, 128))

    def step(q, k, v):
        out = tops.flash_attention_train(q, k, v)
        return torch.autograd.grad(out, (q, k, v), torch.empty_like(out))
    rec = cost.analyze(step, q, k, v)
    assert rec["out"] is not None and rec["diagnostics"] == []
    assert all(g.device.type == "meta" and g.shape == t.shape
               for g, t in zip(rec["out"], (q, k, v)))
    fwd = hardware.flash_attention_train_fwd_work(2, 256, 8, 2, 128, 0,
                                                  True, torch.bfloat16)
    bwd = hardware.flash_attention_train_bwd_work(2, 256, 8, 2, 128, 0,
                                                  True, torch.bfloat16)
    for name, (flops, nbytes) in (("flash_attention_train_fwd", fwd),
                                  ("flash_attention_train_bwd", bwd)):
        got = rec["by_op"][name]
        assert got["count"] == 1 and got["bytes"] == nbytes
        assert got["flops"] == sum(flops.values())
    assert bwd[0]["bfloat16"] == 2.5 * fwd[0]["bfloat16"]


# which gradient calls would take the training kernels on the card
GRAD_ROUTES = [
    # (B, T, S, H, Hkv, D, dtype, q_offset, impl) -> kernel?
    ((8, 1024, 1024, 20, 20, 128, torch.bfloat16, 0, "auto"), True),  # cell
    ((1, 1024, 1024, 20, 20, 128, torch.bfloat16, 0, "auto"), True),
    ((2, 77, 77, 32, 32, 96, torch.bfloat16, 0, "auto"), True),    # padded
    ((2, 333, 333, 64, 4, 64, torch.bfloat16, 0, "auto"), True),   # GQA
    ((1, 9, 9, 4, 1, 40, torch.bfloat16, 0, "auto"), True),
    ((8, 1024, 1024, 20, 20, 128, torch.float32, 0, "auto"), False),
    ((1, 64, 80, 4, 4, 128, torch.bfloat16, 0, "auto"), False),    # T != S
    ((1, 64, 64, 4, 4, 128, torch.bfloat16, 1, "auto"), False),    # offset
    ((1, 64, 64, 4, 4, 128, torch.bfloat16, 0, "ref"), False),
    ((2, 37, 37, 8, 2, 16, torch.bfloat16, 0, "auto"), False),     # smoke D
    ((2, 37, 37, 8, 2, 32, torch.bfloat16, 0, "auto"), False),
    ((2, 37, 37, 8, 2, 12, torch.bfloat16, 0, "auto"), False),     # mma
    ((2, 2048, 2048, 16, 1, 256, torch.bfloat16, 0, "auto"), False),
]


@pytest.mark.parametrize("shape,kernel", GRAD_ROUTES,
                         ids=[f"{s[1]}x{s[2]}-{s[3]}/{s[4]}-D{s[5]}-"
                              f"{str(s[6])[6:]}-off{s[7]}-{s[8]}"
                              for s, _ in GRAD_ROUTES])
def test_grad_route_on_meta(shape, kernel):
    """layers.grad_takes_kernel answers, from shapes, dtypes and strides
    alone, which gradient calls the card would route to the training
    kernels; on meta tensors (as on the CPU) select_attention keeps every
    gradient call on the plain route, counted as such."""
    from repro_torch.models import layers
    B, T, S, H, Hkv, D, dtype, off, impl = shape
    meta = {"device": "meta", "dtype": dtype}
    q = torch.empty(B, T, H, D, **meta).requires_grad_(True)
    k = torch.empty(B, S, Hkv, D, **meta).requires_grad_(True)
    v = torch.empty(B, S, Hkv, D, **meta).requires_grad_(True)
    assert layers.grad_takes_kernel(q, k, v, q_offset=off,
                                    impl=impl) is kernel
    before = dict(layers.select_attention.grad_routes)
    out = layers.select_attention(q, k, v, q_offset=off, impl=impl)
    assert out.shape == q.shape and out.requires_grad
    assert layers.select_attention.grad_routes == {
        "kernel": before["kernel"], "plain": before["plain"] + 1}
    with torch.no_grad():     # no gradient: not counted
        layers.select_attention(q, k, v, q_offset=off, impl=impl)
    assert layers.select_attention.grad_routes["plain"] == \
        before["plain"] + 1


def test_grad_route_needs_a_layout_tma_reads():
    """A bf16 head of 128 that TMA cannot describe (a base off 16 bytes)
    stays on the plain route, as its forward takes mma."""
    from repro_torch.models import layers
    off = torch.empty(1, 9, 4, 136, device="meta", dtype=torch.bfloat16)
    q = off[..., 4:132]
    assert tkernel.route(q, q, q) == "mma"
    assert not layers.grad_takes_kernel(q, q, q)
    assert layers.grad_takes_kernel(off[..., 8:136], off[..., 8:136],
                                    off[..., 8:136])


def test_tma_strides_pack_size_one_dims():
    """An output gradient of batch 1 arrives with a batch stride of 1,
    which PyTorch calls contiguous: the training kernels' strides give
    size-1 dims the packed value, so such a tensor (and q, k, v of batch 1
    or one kv head) is what they take, and other strides are kept."""
    do = torch.empty(1, 32, 4, 64, device="meta").as_strided(
        (1, 32, 4, 64), (1, 256, 64, 1))
    assert do.is_contiguous() and do.stride(0) == 1
    assert tkernel.tma_strides(do) == [8192, 256, 64]
    mqa = torch.empty(2, 9, 1, 128, device="meta").as_strided(
        (2, 9, 1, 128), (1152, 128, 3, 1))
    assert tkernel.tma_strides(mqa) == [1152, 128, 128]
    wide = torch.empty(2, 9, 6, 72, device="meta")[..., :64]
    assert tkernel.tma_strides(wide) == [3888, 432, 72]
    q = do.to(torch.bfloat16)
    assert tkernel.route(q, q, q) == "mma"      # the prefill's own test
    assert tkernel.takes_grad(q, q, q)

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

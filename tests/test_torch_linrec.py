"""The port's linrec (kernels/linrec) against the JAX package on the same
numpy inputs: its plain version against JAX's `linrec(impl="ref")` and the
Pallas `linrec_btd` in interpret mode on tests/test_kernels.py's shapes,
fp32 and bf16, and with a starting state against the models' scan
`repro.models.ssm._chunked_linear_scan`.  Tolerances are test_kernels.py's:
2e-4 fp32, 3e-2 bf16 (the scans differ in the order of their sums).  Then
the dispatch rules.  The CUDA kernel's own tests, which need the card, are
in test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.linrec.kernel import linrec_btd
from repro.kernels.linrec.ops import linrec as jlinrec
from repro.models.ssm import _chunked_linear_scan
from repro_torch.kernels.linrec import kernel as tkernel
from repro_torch.kernels.linrec.ops import linrec
from repro_torch.kernels.linrec.ref import linrec_ref
from repro_torch.models.param import from_reference

DTYPES = {"float32": (jnp.float32, 2e-4), "bfloat16": (jnp.bfloat16, 3e-2)}
# test_kernels.py's (B, T, D, bt, bd)
SHAPES = [(1, 128, 128, 64, 128), (2, 512, 640, 256, 128),
          (3, 256, 512, 64, 512)]


def _ab(B, T, D, dtype, seed=0):
    rng = np.random.default_rng(seed + B * 131 + T * 7 + D)
    jdt = DTYPES[dtype][0]
    a = jnp.asarray(rng.uniform(0.7, 0.999, size=(B, T, D)), jdt)
    b = jnp.asarray(rng.normal(size=(B, T, D)) * 0.1, jdt)
    return (a, b), tuple(from_reference(np.asarray(x)) for x in (a, b))


def _close(got, want, tol):
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,T,D,bt,bd", SHAPES)
def test_plain_version_matches_jax_ref_and_pallas(B, T, D, bt, bd, dtype):
    (a, b), (at, bt_) = _ab(B, T, D, dtype)
    tol = DTYPES[dtype][1]
    got = linrec(at, bt_)
    assert got.shape == (B, T, D)
    _close(got, jlinrec(a, b, impl="ref"), tol)
    _close(got, linrec_btd(a, b, bt=bt, bd=bd, interpret=True), tol)


@pytest.mark.parametrize("T,chunk", [(256, 64), (128, 128), (1, 1)])
def test_h0_matches_chunked_linear_scan(T, chunk):
    """A nonzero starting state: the models' scan, T = 1 being a decode
    step.  The final state is the last row."""
    B, D = 2, 96
    rng = np.random.default_rng(T)
    a = rng.uniform(0.8, 0.999, size=(B, T, D)).astype(np.float32)
    b = rng.normal(size=(B, T, D)).astype(np.float32)
    h0 = rng.normal(size=(B, D)).astype(np.float32)
    want, want_T = _chunked_linear_scan(jnp.asarray(a), jnp.asarray(b),
                                        jnp.asarray(h0), chunk)
    got = linrec(torch.from_numpy(a), torch.from_numpy(b),
                 torch.from_numpy(h0))
    _close(got, want, 2e-4)
    _close(got[:, -1], want_T, 2e-4)


def test_leading_dims_flatten_as_the_model_scan():
    """(B, T, di, N) state through the (B, T, di * N) view, with a
    (B, di, N) starting state, as the mamba layer calls it."""
    B, T, di, N = 2, 64, 12, 4
    rng = np.random.default_rng(1)
    a = rng.uniform(0.8, 0.999, size=(B, T, di, N)).astype(np.float32)
    b = rng.normal(size=(B, T, di, N)).astype(np.float32)
    h0 = rng.normal(size=(B, di, N)).astype(np.float32)
    want, _ = _chunked_linear_scan(jnp.asarray(a), jnp.asarray(b),
                                   jnp.asarray(h0), 32)
    got = linrec(torch.from_numpy(a).reshape(B, T, di * N),
                 torch.from_numpy(b).reshape(B, T, di * N),
                 torch.from_numpy(h0).reshape(B, di * N))
    _close(got.reshape(B, T, di, N), want, 2e-4)
    # (B, di, T, N): the leading dims (B, di) flatten into the batch
    want0, _ = _chunked_linear_scan(jnp.asarray(a), jnp.asarray(b),
                                    jnp.zeros((B, di, N)), 32)
    got4 = linrec(torch.from_numpy(a).permute(0, 2, 1, 3),
                  torch.from_numpy(b).permute(0, 2, 1, 3))
    assert got4.shape == (B, di, T, N)
    _close(got4, np.swapaxes(np.asarray(want0), 1, 2), 2e-4)


def test_dispatch_rules():
    """CPU tensors take the plain version, with no launch; impl="ref" is
    the plain version too; the kernel entry refuses CPU tensors; a
    gradient request raises; an unknown impl raises."""
    (_, _), (a, b) = _ab(2, 33, 40, "float32")
    before = tkernel.linrec_cuda.launches
    assert torch.equal(linrec(a, b), linrec_ref(a, b))
    assert torch.equal(linrec(a, b, impl="ref"), linrec_ref(a, b))
    assert tkernel.linrec_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA device"):
        tkernel.linrec_cuda(a, b)
    with pytest.raises(NotImplementedError, match="backward"):
        linrec(a.clone().requires_grad_(), b)
    with torch.no_grad():
        linrec(a.clone().requires_grad_(), b)
    with pytest.raises(ValueError, match="impl"):
        linrec(a, b, impl="pallas")
    assert tkernel.linrec_cuda.launches == before


def test_plain_version_is_the_step_loop():
    """ref.py is one product and one sum a step in fp32 (what the kernel
    computes, each rounded on its own): bf16 inputs are widened exactly,
    h0 is read and not written."""
    (_, _), (a, b) = _ab(1, 9, 5, "bfloat16")
    h0 = torch.from_numpy(np.random.default_rng(2).normal(
        size=(1, 5)).astype(np.float32))
    h0_copy = h0.clone()
    got = linrec_ref(a, b, h0)
    h = h0
    for t in range(9):
        h = a[:, t].float() * h + b[:, t].float()
        assert torch.equal(got[:, t], h)
    assert torch.equal(h0, h0_copy)


# -- the kernel's route, from layout alone (no launch) -----------------------

def _meta(*shape, dtype=torch.float32):
    return torch.empty(*shape, dtype=dtype, device="meta")


def _scan_shapes():
    """(B, T, D) of every model scan: falcon-mamba-7b's (d_inner x N) and
    recurrentgemma-9b's (lru_width) prefills at the full-width batches and
    at their smoke configs."""
    from repro_torch.configs import get_config, get_smoke_config
    out = []
    for get, B in ((get_config, None), (get_smoke_config, 2)):
        falcon, rg = get("falcon-mamba-7b"), get("recurrentgemma-9b")
        out.append((B or 4, 2048, falcon.d_inner * falcon.ssm_state))
        out.append((B or 2, 2048, rg.lru_width))
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_route_takes_tma_for_the_models_scans(dtype):
    """The models' contiguous scans and their strided (B, T, di * N) views
    (a and b as halves of one buffer) take the pipelined TMA kernel."""
    shapes = _scan_shapes()
    assert (4, 2048, 131_072) in shapes and (2, 2048, 4096) in shapes
    for B, T, D in shapes:
        a = _meta(B, T, D, dtype=dtype)
        assert tkernel.tma_ok(a, a) and tkernel.route(a, a) == "tma"
        ab = _meta(B, T, 2, D, dtype=dtype)
        a, b = ab[:, :, 0], ab[:, :, 1]
        assert not a.is_contiguous()
        assert tkernel.route(a, b) == "tma", (B, T, D)
    # a decode step's own tensors (T = 1) are TMA's to take, but a tile of
    # 32 steps would be padding: the column kernel takes them
    a = _meta(4, 1, 131_072)
    assert tkernel.tma_ok(a, a) and tkernel.route(a, a) == "column"


def test_route_takes_column_for_other_layouts():
    """D = 12 and 130 (test_kernels.py's odd widths), T shorter than a
    tile, unaligned bases and strides that are no multiple of 16 bytes
    take the column kernel; those TMA cannot describe fail tma_ok."""
    cases = {
        "D=12": (_meta(2, 77, 12), True),           # narrower than a strip
        "D=130": (_meta(1, 1000, 130), False),      # 520-byte rows
        "T=31": (_meta(2, 31, 4096), True),
        "bf16 D=36": (_meta(2, 64, 36, dtype=torch.bfloat16), False),
        "unaligned": (_meta(2 * 64 * 128 + 1)[1:].view(2, 64, 128), False),
        "odd time stride": (_meta(2, 64, 129)[..., :128], False),
    }
    for label, (a, capable) in cases.items():
        assert tkernel.tma_ok(a, a) == capable, label
        assert tkernel.route(a, a) == "column", label
    a = _meta(2, 64, 128)
    assert tkernel.route(a, _meta(2 * 64 * 128 + 4)[4:].view(2, 64, 128)) \
        == "tma"                                      # 16 bytes in: aligned
    assert tkernel.route(a, _meta(2 * 64 * 128 + 2)[2:].view(2, 64, 128)) \
        == "column"                                   # 8 bytes in


def test_cuda_entry_refuses_host_tensors_on_either_route():
    (_, _), (a, b) = _ab(2, 40, 64, "float32")
    before = dict(tkernel.linrec_cuda.routes)
    with pytest.raises(ValueError, match="CUDA device"):
        tkernel.linrec_cuda(a, b, route_name="tma")
    assert tkernel.linrec_cuda.routes == before
    assert tkernel.ROUTES == ("column", "tma")


def test_smoke_logits_draws_runs_on_the_host(capsys, monkeypatch):
    """examples/smoke_logits_draws.py on the CPU, where both paths are the
    plain versions: every gap is 0 and every scan repeats its bits."""
    import json
    import sys

    from repro_torch.examples import smoke_logits_draws
    monkeypatch.setattr(sys, "argv", [
        "smoke_logits_draws", "--device", "cpu", "--draws", "2",
        "--repeat-draws", "1", "--repeats", "1"])
    assert smoke_logits_draws.main() == 0
    report = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert report["device"] == "cpu" and report["unequal_scans"] == 0
    assert report["scans"] > 0
    for arch in smoke_logits_draws.ARCHS:
        assert report["archs"][arch] == {"draws": 2, "worst": 0.0,
                                         "outside_tolerance": []}

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

"""The port's quant8 (kernels/quant8) against the JAX package on the same
numpy inputs: its plain version against `repro.core.compression`'s
`_symmetric_q8` layouts and against the Pallas `quantize_blocked` /
`dequantize_blocked` (interpret mode, as tests/test_kernels.py runs them),
non-finite rows included.  fp32 q and scales are bit-equal; bf16 inputs
convert exactly to fp32, and q may differ by 1 (test_kernels.py's bound).
The CUDA kernels' own tests, which need no JAX, are in test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import compression as jcomp
from repro.kernels.quant8 import ops as jops
from repro.kernels.quant8.kernel import dequantize_blocked, quantize_blocked
from repro_torch.kernels.quant8 import kernel as tkernel
from repro_torch.kernels.quant8 import ops as tops
from repro_torch.kernels.quant8.ref import (dequantize_rows_ref,
                                            quantize_rows_ref)
from repro_torch.models.param import from_reference

DTYPES = {"float32": (jnp.float32, 0), "bfloat16": (jnp.bfloat16, 1)}


def _x(shape, seed, decades=0.0):
    """Normal entries, each row scaled by 10**U(-decades, decades)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape)
    if decades:
        x = x * 10.0 ** rng.uniform(-decades, decades,
                                    size=shape[:-1] + (1,))
    return x.astype(np.float32)


def _poison(x):
    """Rows 0-3: one NaN, one +inf, one -inf, all zero (the scale clamp)."""
    x = x.copy()
    x[0, 1] = np.nan
    x[1, -1] = np.inf
    x[2, 0] = -np.inf
    x[3] = 0.0
    return x


def _pair(x, dtype):
    jdt, _ = DTYPES[dtype]
    xj = jnp.asarray(x, jdt)
    return xj, from_reference(np.asarray(xj))


def _assert_q_scale(qt, st, qj, sj, q_tol, scale_rtol=0.0):
    st, sj = st.numpy(), np.asarray(sj, np.float32)
    if scale_rtol:
        np.testing.assert_allclose(st, sj, rtol=scale_rtol)
    else:
        np.testing.assert_array_equal(st, sj)      # NaN == NaN here
    dq = np.abs(qt.numpy().astype(np.int32) - np.asarray(qj, np.int32))
    assert dq.max() <= q_tol


@pytest.mark.parametrize("shape,decades", [((4096, 257), 7.0),
                                           ((64, 5), 3.0),
                                           ((5, 1027), 0.0),
                                           ((4, 151_936), 1.0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rows_ref_matches_compression_rowwise(shape, decades, dtype):
    """The plain version against JAX's quantize_rowwise /
    dequantize_rowwise, over seven decades of row scale, odd and long C."""
    xj, xt = _pair(_poison(_x(shape, 1, decades)), dtype)
    qt, st = quantize_rows_ref(xt)
    qj, sj = jcomp.quantize_rowwise(xj)
    assert qt.dtype == torch.int8 and st.shape == (shape[0], 1)
    _assert_q_scale(qt, st, qj, sj, DTYPES[dtype][1])
    np.testing.assert_array_equal(
        dequantize_rows_ref(qt, st).numpy(),
        np.asarray(jcomp.dequantize_rowwise(jnp.asarray(qt.numpy()), sj)))


def test_nonfinite_rows_follow_the_reference():
    """[1, nan, 2] -> q 0, scale nan; [1, inf, -3] -> q 0, scale inf; both
    dequantise to NaN; an all-zero row -> q 0, scale 0, zeros back."""
    x = np.array([[1, np.nan, 2], [1, np.inf, -3], [0, 0, 0]], np.float32)
    q, s = quantize_rows_ref(torch.from_numpy(x))
    assert not q.any()
    assert np.isnan(s[0, 0]) and np.isposinf(s[1, 0]) and s[2, 0] == 0
    out = dequantize_rows_ref(q, s)
    assert torch.isnan(out[:2]).all() and not out[2].any()


@pytest.mark.parametrize("C", [128, 256, 384])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rows_ref_matches_pallas_interpret(C, dtype):
    """The Pallas kernels on their (rows, BLOCK) layout, interpret mode;
    9 rows force the wrapper's row pad.  Under jit XLA may round the
    scale's division by 127 one ulp off the eager result, so scales are
    held to test_kernels.py's rtol 1e-6 here (NaN and inf in place)."""
    xj, xt = _pair(_poison(_x((9, C), C, 4.0)), dtype)
    qj, sj = quantize_blocked(xj.astype(jnp.float32), interpret=True)
    qt, st = quantize_rows_ref(xt)
    _assert_q_scale(qt, st, qj, sj, DTYPES[dtype][1], scale_rtol=1e-6)
    for out_dtype, jdt in ((torch.float32, jnp.float32),
                           (torch.bfloat16, jnp.bfloat16)):
        want = dequantize_blocked(jnp.asarray(qt.numpy()),
                                  jnp.asarray(st.numpy()), out_dtype=jdt,
                                  interpret=True)
        got = dequantize_rows_ref(qt, st, out_dtype)
        assert got.dtype == out_dtype
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))


@pytest.mark.parametrize("n", [100, 256, 257, 1000, 4096])
@pytest.mark.parametrize("block", [64, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_blockwise_matches_reference(n, block, dtype):
    """ops.quantize / dequantize (pad to a block multiple) against
    core.compression's blockwise layout and the JAX ops' Pallas path."""
    xj, xt = _pair(_x((n,), n + block) * 3.0, dtype)
    qt, st = tops.quantize(xt, block=block)
    qj, sj = jcomp.quantize_blockwise(xj, block=block)
    assert qt.shape == (-(-n // block), block) and st.dim() == 1
    _assert_q_scale(qt, st, qj, sj, DTYPES[dtype][1])
    if block == 256:
        qp, sp = jops.quantize(xj)                 # Pallas, interpret
        _assert_q_scale(qt, st, qp, sp, DTYPES[dtype][1], scale_rtol=1e-6)
    got = tops.dequantize(qt, st, (n,))
    want = jcomp.dequantize_blockwise(jnp.asarray(qt.numpy()), sj, (n,))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape", [(5, 7), (3, 300), (1000,), (2, 3, 130)])
def test_rowwise_ops_keep_shape(shape):
    xj, xt = _pair(_x(shape, 5) * 2.0, "float32")
    qt, st = tops.quantize_rowwise(xt)
    assert qt.shape == xt.shape and st.shape == xt.shape[:-1] + (1,)
    qj, sj = jcomp.quantize_rowwise(xj)
    _assert_q_scale(qt, st, qj, sj, 0)
    np.testing.assert_array_equal(
        tops.dequantize_rowwise(qt, st, out_dtype=torch.bfloat16)
        .float().numpy(),
        np.asarray(jops.dequantize_rowwise(jnp.asarray(qt.numpy()), sj,
                                           out_dtype=jnp.bfloat16),
                   np.float32))


def test_host_tensors_take_the_plain_version_and_impl_is_checked():
    x = torch.from_numpy(_x((6, 40), 2))
    before = (tkernel.quantize_rows_cuda.launches,
              tkernel.dequantize_rows_cuda.launches)
    q, s = tops.quantize_rowwise(x)
    qr, sr = tops.quantize_rowwise(x, impl="ref")
    assert torch.equal(q, qr) and torch.equal(s, sr)
    assert torch.equal(tops.dequantize_rowwise(q, s),
                       tops.dequantize_rowwise(q, s, impl="ref"))
    assert (tkernel.quantize_rows_cuda.launches,
            tkernel.dequantize_rows_cuda.launches) == before
    with pytest.raises(ValueError):
        tops.quantize_rowwise(x, impl="pallas")
    with pytest.raises(ValueError):
        tkernel.quantize_rows_cuda(x)              # host tensor: no launch
    with pytest.raises(ValueError):
        tkernel.dequantize_rows_cuda(q, s)
    assert tkernel.quantize_rows_cuda.launches == before[0]

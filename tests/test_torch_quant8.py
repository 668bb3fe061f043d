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
    before = (tkernel.quantize_grouped_cuda.launches,
              tkernel.dequantize_grouped_cuda.launches)
    q, s = tops.quantize_rowwise(x)
    qr, sr = tops.quantize_rowwise(x, impl="ref")
    assert torch.equal(q, qr) and torch.equal(s, sr)
    assert torch.equal(tops.dequantize_rowwise(q, s),
                       tops.dequantize_rowwise(q, s, impl="ref"))
    assert (tkernel.quantize_grouped_cuda.launches,
            tkernel.dequantize_grouped_cuda.launches) == before
    with pytest.raises(ValueError):
        tops.quantize_rowwise(x, impl="pallas")
    with pytest.raises(ValueError):
        tkernel.quantize_rows_cuda(x)              # host tensor: no launch
    with pytest.raises(ValueError):
        tkernel.dequantize_rows_cuda(q, s)
    assert tkernel.quantize_grouped_cuda.launches == before[0]


def _mixed_leaves(seed):
    """A mixed leaf list: C = 5, 256 and 1,027 side by side, a one-row
    leaf, a 3-d leaf, NaN/inf/zero rows in the first."""
    return [_poison(_x((9, 5), seed, 3.0)), _x((1, 1027), seed + 1, 2.0),
            _x((2, 3, 256), seed + 2, 4.0), _poison(_x((6, 1027), seed + 3)),
            _x((40, 256), seed + 4, 7.0)]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_plain_version_bit_equal_to_reference(seed, dtype):
    """The grouped plain version (what CPU tensors and impl="ref" take,
    and what the card's grouped kernels are held to) against the JAX
    package's quantize_rowwise / dequantize_rowwise leaf by leaf: q,
    scales and both output dtypes bit-equal, NaN/inf rows included."""
    pairs = [_pair(x, dtype) for x in _mixed_leaves(seed)]
    got = tops.quantize_rowwise_grouped([t for _, t in pairs])
    assert len(got) == len(pairs)
    for (xj, xt), (qt, st) in zip(pairs, got):
        qj, sj = jcomp.quantize_rowwise(xj)
        assert qt.shape == xt.shape and st.shape == xt.shape[:-1] + (1,)
        _assert_q_scale(qt, st, qj, sj, 0)
    for out_dtype, jdt in ((torch.float32, jnp.float32),
                           (torch.bfloat16, jnp.bfloat16)):
        outs = tops.dequantize_rowwise_grouped(
            [q for q, _ in got], [s for _, s in got], out_dtype=out_dtype)
        for (qt, st), o in zip(got, outs):
            want = jcomp.dequantize_rowwise(jnp.asarray(qt.numpy()),
                                            jnp.asarray(st.numpy()),
                                            out_dtype=jdt)
            assert o.dtype == out_dtype and o.shape == qt.shape
            np.testing.assert_array_equal(o.float().numpy(),
                                          np.asarray(want, np.float32))


def test_grouped_ops_equal_their_single_forms_on_the_host():
    """Grouped rows, rowwise and blockwise calls equal the single-tensor
    calls leaf by leaf (mixed fp32 and bf16 in one list), impl="ref"
    equals impl="auto" on host tensors, and nothing launches."""
    xs = [from_reference(x) for x in _mixed_leaves(3)]
    xs[1] = xs[1].to(torch.bfloat16)
    before = (tkernel.quantize_grouped_cuda.launches,
              tkernel.dequantize_grouped_cuda.launches)
    for impl in ("auto", "ref"):
        rows = tops.quantize_rows_grouped(
            [x.reshape(-1, x.shape[-1]) for x in xs], impl=impl)
        blocks = tops.quantize_grouped(xs, block=64, impl=impl)
        back = tops.dequantize_grouped([q for q, _ in blocks],
                                       [s for _, s in blocks],
                                       [x.shape for x in xs], impl=impl)
        for x, (q, s), (qb, sb), b in zip(xs, rows, blocks, back):
            qr, sr = quantize_rows_ref(x.reshape(-1, x.shape[-1]))
            assert torch.equal(q, qr)
            torch.testing.assert_close(s, sr, rtol=0, atol=0,
                                       equal_nan=True)
            q1, s1 = tops.quantize(x, block=64)
            assert torch.equal(qb, q1)
            torch.testing.assert_close(sb, s1, rtol=0, atol=0,
                                       equal_nan=True)
            torch.testing.assert_close(b, tops.dequantize(q1, s1, x.shape),
                                       rtol=0, atol=0, equal_nan=True)
    assert tops.quantize_rows_grouped([]) == []
    with pytest.raises(ValueError):
        tops.dequantize_rows_grouped([rows[0][0]], [], impl="ref")
    assert (tkernel.quantize_grouped_cuda.launches,
            tkernel.dequantize_grouped_cuda.launches) == before
    with pytest.raises(ValueError):
        tkernel.quantize_grouped_cuda(xs)           # host tensors: no launch
    with pytest.raises(ValueError):
        tkernel.dequantize_grouped_cuda([rows[0][0]], [rows[0][1]])


def test_int8_kv_cache_quantises_k_and_v_in_one_call(monkeypatch):
    """The int8 cache's prefill pack, decode write and read each make one
    grouped quant8 call for K and V together, and give what per-tensor
    quantize_kv / dequantize_kv give."""
    from repro_torch.models import cache as tcache
    rng = np.random.default_rng(11)
    kk, vv, k1, v1 = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                      .to(torch.bfloat16)
                      for s in ((2, 7, 2, 8), (2, 7, 2, 8), (2, 1, 2, 8),
                                (2, 1, 2, 8)))
    spec = tcache.CacheSpec.parse("head/int8")
    calls = {}
    for name in ("quantize_rows_grouped", "dequantize_rows_grouped"):
        real = getattr(tops, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*a, **kw)
        monkeypatch.setattr(tops, name, spy)
    cache = tcache.pack_prefill_cache(None, kk, vv, window=0, spec=spec)
    assert calls == {"quantize_rows_grouped": 1}
    cache = tcache.write_kv(cache, k1, v1, torch.tensor([7, 9]))
    assert calls == {"quantize_rows_grouped": 2}
    k, v = tcache.read_kv(cache)
    assert calls == {"quantize_rows_grouped": 2, "dequantize_rows_grouped": 1}
    for got, x, x1 in ((k, kk, k1), (v, vv, v1)):
        q, s = tcache.quantize_kv(x)
        assert got.dtype == torch.bfloat16
        assert torch.equal(got[:, :7], tcache.dequantize_kv(q, s))
        q1, s1 = tcache.quantize_kv(x1)
        want = tcache.dequantize_kv(q1, s1)
        assert torch.equal(got[0, 7], want[0, 0])
        assert torch.equal(got[1, 9], want[1, 0])

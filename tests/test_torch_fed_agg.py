"""The port's fed_agg (kernels/fed_agg) against the JAX package's Pallas
fed_agg_2d (interpret mode, as tests/test_kernels.py runs it) and its
plain reference, and the port's weighted_average / async_merge against
JAX's.  The CUDA kernel's own tests, which need no JAX, are in
test_torch_cuda.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import aggregation as jagg
from repro.kernels.fed_agg.kernel import fed_agg_2d
from repro.kernels.fed_agg.ref import fed_agg_2d_ref as jax_ref
from repro_torch.core import aggregation as tagg
from repro_torch.kernels.fed_agg import kernel as tkernel
from repro_torch.kernels.fed_agg.ops import fed_agg, fed_agg_tree
from repro_torch.models.param import from_reference, to_numpy
from repro_torch.tree import leaves

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(K, n, seed=0):
    rng = np.random.default_rng(seed + 97 * K + n)
    return rng.normal(size=(K, n)).astype(np.float32), \
        rng.dirichlet([1.0] * K).astype(np.float32)


def _f32(a):
    return np.asarray(jnp.asarray(a, jnp.float32)) if not \
        isinstance(a, torch.Tensor) else a.float().numpy()


@pytest.mark.parametrize("K", [1, 2, 5, 8])
@pytest.mark.parametrize("n", [128, 2048, 5000])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fed_agg_matches_pallas_and_ref(K, n, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    x, w = _inputs(K, n)
    xj = jnp.asarray(x, jdt)
    xt = torch.from_numpy(x).to(tdt)      # same RNE rounding as jnp's cast
    assert np.array_equal(_f32(xj), _f32(xt))
    got = fed_agg(xt, torch.from_numpy(w))
    assert got.dtype == tdt and got.shape == (n,)
    pallas = fed_agg_2d(xj, jnp.asarray(w), interpret=True)
    ref = jax_ref(xj, jnp.asarray(w))
    for want in (pallas, ref):
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


def test_fed_agg_keeps_trailing_shape_and_ref_override():
    x, w = _inputs(3, 60)
    xt = torch.from_numpy(x).reshape(3, 6, 10)
    got = fed_agg(xt, torch.from_numpy(w))
    assert got.shape == (6, 10)
    assert torch.equal(got, fed_agg(xt, torch.from_numpy(w), impl="ref"))
    with pytest.raises(ValueError):
        fed_agg(xt, torch.from_numpy(w), impl="pallas")


def test_cuda_binding_rejects_host_tensors_without_launching():
    x, w = _inputs(2, 64)
    before = tkernel.fed_agg_cuda.launches
    with pytest.raises(ValueError):
        tkernel.fed_agg_cuda(torch.from_numpy(x), torch.from_numpy(w))
    assert tkernel.fed_agg_cuda.launches == before


def _trees(k, seed, dtype_b=np.float32):
    rng = np.random.default_rng(seed)
    return [{"a": rng.normal(size=(33, 7)).astype(np.float32),
             "b": {"c": rng.normal(size=(130,)).astype(dtype_b),
                   "d": rng.normal(size=(4, 5, 6)).astype(np.float32)}}
            for _ in range(k)]


def test_weighted_average_matches_jax():
    trees = _trees(4, 1)
    w = np.array([0.1, 0.2, 0.3, 0.4])
    want = jagg.weighted_average([jax.tree.map(jnp.asarray, t)
                                  for t in trees], w)
    got = tagg.weighted_average([from_reference(t) for t in trees], w)
    for g, x in zip(leaves(to_numpy(got)), jax.tree.leaves(want)):
        np.testing.assert_allclose(g, np.asarray(x), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        tagg.weighted_average([from_reference(t) for t in trees],
                              [0.5, 0.2, 0.2, 0.2])


@pytest.mark.parametrize("alpha", [0.0, 0.35, 0.6, 1.0])
def test_async_merge_matches_jax(alpha):
    s, w = _trees(2, 2)
    want = jagg.async_merge(jax.tree.map(jnp.asarray, s),
                            jax.tree.map(jnp.asarray, w), alpha)
    got = tagg.async_merge(from_reference(s), from_reference(w), alpha)
    for g, x in zip(leaves(to_numpy(got)), jax.tree.leaves(want)):
        np.testing.assert_allclose(g, np.asarray(x), rtol=1e-6, atol=1e-6)


def test_mixed_dtype_tree_matches_weighted_average():
    """One launch per dtype: an fp32 + bf16 tree aggregates like JAX's
    weighted_average (2e-2 on the bf16 leaf, as test_kernels.py)."""
    trees = _trees(3, 3)
    jt = [{"a": jnp.asarray(t["a"]),
           "b": {"c": jnp.asarray(t["b"]["c"], jnp.bfloat16),
                 "d": jnp.asarray(t["b"]["d"])}} for t in trees]
    tt = [from_reference(t) for t in jt]
    assert tt[0]["b"]["c"].dtype == torch.bfloat16
    w = [0.2, 0.5, 0.3]
    got = fed_agg_tree(tt, w)
    assert got["b"]["c"].dtype == torch.bfloat16
    want = jagg.weighted_average(jt, w)
    for g, x, tol in zip(leaves(got), jax.tree.leaves(want),
                         (1e-6, 2e-2, 1e-6)):
        np.testing.assert_allclose(g.float().numpy(), _f32(x), rtol=tol,
                                   atol=tol)

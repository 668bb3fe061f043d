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
    before = tkernel.fed_agg_grouped_cuda.launches
    with pytest.raises(ValueError):
        tkernel.fed_agg_cuda(torch.from_numpy(x), torch.from_numpy(w))
    assert tkernel.fed_agg_grouped_cuda.launches == before


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


# -- the grouped merge: its plain path against JAX, its launch tables -------

def _cnn_members(k, seed):
    """k members shaped as flight-cnn-mnist's own tree (6 leaves, 20,490
    params), normal values from numpy."""
    from repro_torch import threefry
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    shapes = {name: tuple(t.shape) for name, t in build_model(get_config(
        "flight-cnn-mnist")).init(threefry.key(0), "cpu").items()}
    rng = np.random.default_rng(seed)
    return [{n: rng.normal(size=s).astype(np.float32)
             for n, s in shapes.items()} for _ in range(k)]


def _mixed_members(k, seed):
    """k members of an fp32 + bf16 tree with leaves of odd sizes."""
    return [{"a": t["a"],
             "b": {"c": jnp.asarray(t["b"]["c"], jnp.bfloat16),
                   "d": t["b"]["d"]},
             "e": jnp.asarray(t["b"]["c"][:7], jnp.bfloat16)}
            for t in _trees(k, seed)]


@pytest.mark.parametrize("tree", ["flight-cnn-mnist", "mixed"])
@pytest.mark.parametrize("op", ["weighted_average", "async_merge"])
def test_grouped_plain_path_matches_jax(tree, op):
    """fed_agg_tree's plain path (fed_agg_grouped_ref, leaf by leaf) against
    JAX's weighted_average / async_merge from the same numpy members: 1e-6
    on fp32 leaves, 2e-2 on bf16 (test_kernels.py's tolerances)."""
    k = 5 if op == "weighted_average" else 2
    members = _cnn_members(k, 7) if tree == "flight-cnn-mnist" \
        else _mixed_members(k, 7)
    jt = [jax.tree.map(jnp.asarray, m) for m in members]
    tt = [from_reference(m) for m in jt]
    if tree == "flight-cnn-mnist":
        assert len(leaves(tt[0])) == 6
        assert sum(l.numel() for l in leaves(tt[0])) == 20_490
    if op == "weighted_average":
        w = np.random.default_rng(3).dirichlet([1.0] * k)
        want = jagg.weighted_average(jt, w)
        got = tagg.weighted_average(tt, w)
    else:
        want = jagg.async_merge(jt[0], jt[1], 0.35)
        got = tagg.async_merge(tt[0], tt[1], 0.35)
    for g, x in zip(leaves(got), jax.tree.leaves(want)):
        assert g.dtype == from_reference(x).dtype and g.shape == x.shape
        tol = 2e-2 if g.dtype == torch.bfloat16 else 1e-6
        np.testing.assert_allclose(g.float().numpy(), _f32(x), rtol=tol,
                                   atol=tol)


def test_grouped_ref_is_the_2d_ref_leaf_by_leaf():
    """fed_agg_grouped_ref computes each leaf as fed_agg_2d_ref over its K
    members, with the weights rounded once from float64 to fp32."""
    from repro_torch.kernels.fed_agg.ref import (fed_agg_2d_ref,
                                                 fed_agg_grouped_ref)
    members = [leaves(from_reference(m)) for m in _mixed_members(3, 2)]
    w = np.array([0.1, 0.7, 0.2])
    got = fed_agg_grouped_ref(members, w)
    w32 = torch.tensor(w, dtype=torch.float32)
    for l, g in enumerate(got):
        want = fed_agg_2d_ref(torch.stack([m[l].reshape(-1)
                                           for m in members]), w32)
        assert g.shape == members[0][l].shape
        assert torch.equal(g.reshape(-1), want)


def test_plan_one_launch_while_the_tree_fits():
    """A tree within capacity is one launch, one part a leaf holding all K
    members, first tiles the running sum of the leaves' tiles; leaves of
    no tile are left out."""
    (launch,) = tkernel.plan([3, 1, 0, 5], K=2, slots=2048, parts=128)
    assert launch == [(0, 0, 2, 0), (1, 0, 2, 3), (3, 0, 2, 4)]
    # flight-cnn-mnist's 6 leaves at K = 2 (the async merge) and K = 5
    tiles = [1, 1, 1, 1, 1, 16]
    for K in (2, 5):
        (launch,) = tkernel.plan(tiles, K=K, slots=2048, parts=128)
        assert [p[3] for p in launch] == [0, 1, 2, 3, 4, 5]
        assert all(p[1:3] == (0, K) for p in launch)
    assert tkernel.plan([0, 0], K=3, slots=8, parts=8) == []


def test_plan_splits_past_capacity():
    """More leaves than parts, or K x L beyond the slots, becomes more
    launches, each leaf whole where a launch can hold it; a leaf with more
    members than a launch holds is split in k order over consecutive
    launches (an fp32 partial sum carried between them)."""
    launches = tkernel.plan([1] * 5, K=2, slots=64, parts=2)
    assert [[p[0] for p in l] for l in launches] == [[0, 1], [2, 3], [4]]
    launches = tkernel.plan([2, 2, 2], K=3, slots=7, parts=8)
    assert launches == [[(0, 0, 3, 0), (1, 0, 3, 2)], [(2, 0, 3, 0)]]
    launches = tkernel.plan([4, 1], K=10, slots=4, parts=8)
    assert launches == [[(0, 0, 4, 0)], [(0, 4, 8, 0)], [(0, 8, 10, 0)],
                        [(1, 0, 4, 0)], [(1, 4, 8, 0)], [(1, 8, 10, 0)]]
    # the capacity edge: K x L == slots is one launch; one member more and
    # the last leaf goes whole into a second
    assert len(tkernel.plan([1] * 16, K=128, slots=2048, parts=128)) == 1
    launches = tkernel.plan([1] * 16, K=129, slots=2048, parts=128)
    assert [len(l) for l in launches] == [15, 1]
    assert launches[1] == [(15, 0, 129, 0)]


def test_pack_codes_slots_weights_and_partials():
    """pack() lays a launch out as the C interface reads it: per part (out,
    acc, n, first tile, first slot, k, dtype code, partial), the member
    pointers slot by slot and their fp32 weights; a split leaf's parts
    write, then read, its partial buffer and only the last writes the
    leaf."""
    K = 3
    ptrs = [[1000 + 10 * k + l for l in range(2)] for k in range(K)]
    outs, partials = [500, 600], {0: 700, 1: 800}
    sizes, codes = [5000, 3], [0, 1]
    w32 = np.array([0.25, 0.5, 0.125], np.float32)
    (launch,) = tkernel.plan([5, 1], K=K, slots=8, parts=4)
    rows, x, w = tkernel.pack(launch, K, ptrs, outs, partials, sizes, codes,
                              w32.tolist())
    assert rows == [(500, 0, 5000, 0, 0, 3, 0, 0), (600, 0, 3, 5, 3, 3, 1, 0)]
    assert x == [1000, 1010, 1020, 1001, 1011, 1021]
    assert w == [0.25, 0.5, 0.125] * 2
    launches = tkernel.plan([5, 1], K=K, slots=2, parts=4)
    packed = [tkernel.pack(l, K, ptrs, outs, partials, sizes, codes,
                           w32.tolist()) for l in launches]
    assert [r for r, _, _ in packed] == [
        [(700, 0, 5000, 0, 0, 2, 0, 1)], [(500, 700, 5000, 0, 0, 1, 0, 0)],
        [(800, 0, 3, 0, 0, 2, 1, 1)], [(600, 800, 3, 0, 0, 1, 1, 0)]]
    assert [x for _, x, _ in packed] == [[1000, 1010], [1020], [1001, 1011],
                                         [1021]]
    assert [w for _, _, w in packed] == [[0.25, 0.5], [0.125]] * 2
    # the dtype codes and tiles of the wrapper: 1,024 fp32 or 2,048 bf16
    assert tkernel.DTYPE_CODE == {torch.float32: 0, torch.bfloat16: 1}
    assert tkernel.TILE_ELEMS == {0: 1024, 1: 2048}

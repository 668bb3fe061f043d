"""The slice as a whole: the port's compressed island exchange
(core/compression, aggregation.mix_islands, core/federated,
launch/steps.make_fl_aggregate, core/hierarchy, the server's fog topology
and examples/fl_exchange) against the JAX package on the same numpy
inputs.

Tolerances: integer and host-side results (q, wire bytes, mixing matrices,
top-k masks) are exact; fp32 leaves within 1e-5 and the bf16 leaf within
2e-2 (test_kernels.py's); a two-tier compressed exchange within one
quantisation step, because a one-ulp difference after the fog hop can move
one q of the cloud hop by 1 (as tests/test_hierarchy.py bounds it)."""
import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config
from repro.core import aggregation as jagg
from repro.core import client as jclient
from repro.core import compression as jcomp
from repro.core import federated as jfed
from repro.core import hierarchy as jhier
from repro.launch import steps as jsteps
from repro.models import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.core import aggregation as tagg
from repro_torch.core import client as tclient
from repro_torch.core import compression as tcomp
from repro_torch.core import federated as tfed
from repro_torch.core import hierarchy as thier
from repro_torch.examples import fl_exchange
from repro_torch.kernels.quant8 import kernel as q8kernel
from repro_torch.launch import steps as tsteps
from repro_torch.models import build_model
from repro_torch.models.param import from_reference, to_numpy
from repro_torch.tree import leaves

ROOT = Path(__file__).resolve().parents[1]
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
CMODES = ("q8", "topk", "q8_topk")


def _np32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close(got, want, tol=None):
    """Leaf for leaf; fp32 leaves to 1e-5, bf16 to 2e-2 unless `tol`."""
    gl, wl = leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        t = TOL[str(g.dtype).removeprefix("torch.")] if tol is None else tol
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype)
        np.testing.assert_allclose(_np32(g), _np32(w), rtol=t, atol=t)


def _tree(P, seed=0, delta=0.05):
    """(stacked, base) numpy trees: fp32 matrix, odd-width fp32 bias, a bf16
    leaf; islands = base + N(0, delta)."""
    rng = np.random.default_rng(seed)
    one = {"w": rng.normal(size=(6, 40)), "b": rng.normal(size=(37,)),
           "ln": rng.normal(size=(16,))}
    base = {k: np.broadcast_to(v, (P,) + v.shape) for k, v in one.items()}
    stacked = {k: v + rng.normal(size=v.shape) * delta
               for k, v in base.items()}
    return stacked, base


def _both(tree):
    """numpy tree -> (JAX tree, port tree) with identical values: ln bf16."""
    dt = {"ln": jnp.bfloat16}
    jt = {k: jnp.asarray(v, dt.get(k, jnp.float32)) for k, v in tree.items()}
    return jt, from_reference({k: np.asarray(v) for k, v in jt.items()})


# ---- compression ----------------------------------------------------------

@pytest.mark.parametrize("mode", CMODES)
@pytest.mark.parametrize("block", [64, 256])
def test_compress_tree_matches_jax(mode, block):
    """Wire form and round trip: q8 q/scales bit-equal, top-k indices equal
    (ties keep the lower index, as jax.lax.top_k), round trip exact."""
    stacked, _ = _tree(1, seed=3)
    jt, tt = _both({k: v[0] for k, v in stacked.items()})
    jc = jcomp.compress_tree(jt, mode=mode, block=block, k_frac=0.1)
    tc = tcomp.compress_tree(tt, mode=mode, block=block, k_frac=0.1)
    for k in jt:
        assert tc[k]["shape"] == jc[k]["shape"]
        assert tc[k]["dtype"] == jc[k]["dtype"]
        if mode == "q8":
            np.testing.assert_array_equal(tc[k]["q"].numpy(),
                                          np.asarray(jc[k]["q"]))
            np.testing.assert_array_equal(tc[k]["scale"].numpy(),
                                          np.asarray(jc[k]["scale"]))
        else:
            np.testing.assert_array_equal(tc[k]["idx"].numpy(),
                                          np.asarray(jc[k]["idx"]))
    _close(tcomp.decompress_tree(tc), jcomp.decompress_tree(jc), tol=0.0)


@pytest.mark.parametrize("mode", ["none", "q8", "topk", "q8_topk",
                                  "q8_rowwise"])
def test_compressed_bytes_exact(mode):
    stacked, _ = _tree(3, seed=1)
    jt, tt = _both(stacked)
    for block, k_frac in ((256, 0.05), (64, 0.3), (100, 1.0)):
        assert tcomp.compressed_bytes(tt, mode=mode, block=block,
                                      k_frac=k_frac) == \
            jcomp.compressed_bytes(jt, mode=mode, block=block, k_frac=k_frac)
    with pytest.raises(ValueError):
        tcomp.compressed_bytes(tt, mode="q4")


def test_topk_selection_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 40, 5)).astype(np.float32)
    x[1] = 0.0                                     # an all-zero member
    for batch_dims in (0, 1):
        for k_frac in (0.05, 0.5, 1.0):
            np.testing.assert_array_equal(
                tcomp.topk_mask(torch.from_numpy(x), k_frac=k_frac,
                                batch_dims=batch_dims).numpy(),
                np.asarray(jcomp.topk_mask(jnp.asarray(x), k_frac=k_frac,
                                           batch_dims=batch_dims)))
    x[2, :4] = 1.5                                 # ties at the k-th value
    for member in x:
        idx, val = tcomp.sparsify_topk(torch.from_numpy(member), k_frac=0.1)
        jidx, jval = jcomp.sparsify_topk(jnp.asarray(member), k_frac=0.1)
        assert idx.dtype == torch.int32
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(val.numpy(), np.asarray(jval))


@pytest.mark.parametrize("mode", CMODES)
def test_error_feedback_matches_jax(mode):
    rng = np.random.default_rng(4)
    like = {"w": np.zeros((192,), np.float32)}
    jef = jcomp.ErrorFeedback(jax.tree.map(jnp.asarray, like))
    tef = tcomp.ErrorFeedback(from_reference(like))
    for _ in range(5):
        d = {"w": (rng.normal(size=192) * 0.02).astype(np.float32)}
        jef.compress(jax.tree.map(jnp.asarray, d), mode=mode, k_frac=0.1)
        tef.compress(from_reference(d), mode=mode, k_frac=0.1)
        np.testing.assert_allclose(tef.residual["w"].numpy(),
                                   np.asarray(jef.residual["w"]),
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("mode", CMODES)
def test_roundtrip_islands_matches_jax(mode):
    stacked, base = _tree(3, seed=5)
    (js, ts), (jb, tb) = _both(stacked), _both(base)
    _close(tcomp.roundtrip_islands(ts, tb, mode=mode, k_frac=0.2),
           jcomp.roundtrip_islands(js, jb, mode=mode, k_frac=0.2))


# ---- the exchange ---------------------------------------------------------

@pytest.mark.parametrize("P", [2, 3, 8])
def test_mix_islands_matches_jax(P):
    """fp32 leaves: one (P, P) x (P, N) product; the bf16 leaf: JAX's
    elementwise bf16 branch (weights rounded to bf16 first)."""
    stacked, _ = _tree(P, seed=P)
    js, ts = _both(stacked)
    rng = np.random.default_rng(P)
    M = rng.dirichlet(np.ones(P), size=P)
    got = tagg.mix_islands(ts, M)
    assert got["ln"].dtype == torch.bfloat16
    _close(got, jagg.mix_islands(js, jnp.asarray(M, jnp.float32)))
    _close(tfed.fl_aggregate(ts, torch.as_tensor(M)),
           jfed.fl_aggregate(js, jnp.asarray(M, jnp.float32)))


@pytest.mark.parametrize("mode", ["none", "q8", "topk", "q8_topk"])
@pytest.mark.parametrize("P", [2, 4])
def test_fl_aggregate_compressed_matches_jax(mode, P):
    stacked, base = _tree(P, seed=10 + P)
    (js, ts), (jb, tb) = _both(stacked), _both(base)
    M = tfed.selection_mixing(np.arange(1, P + 1), np.ones(P))
    want = jfed.fl_aggregate_compressed(js, jb, jnp.asarray(M, jnp.float32),
                                        mode=mode, k_frac=0.2)
    got = tfed.fl_aggregate_compressed(ts, tb, M, mode=mode, k_frac=0.2)
    _close(got, want)
    assert torch.equal(got["w"], tfed.fl_aggregate_compressed(
        ts, tb, M, mode=mode, k_frac=0.2, impl="ref")["w"])
    with pytest.raises(ValueError):
        tfed.fl_aggregate_compressed(ts, tb, M, mode="q4")


def test_make_fl_aggregate_modes():
    stacked, base = _tree(2, seed=7)
    (js, ts), (jb, tb) = _both(stacked), _both(base)
    M = tfed.selection_mixing(np.ones(2), np.ones(2))
    Mj = jnp.asarray(M, jnp.float32)
    for compress in (False, None, "none"):
        assert tsteps.make_fl_aggregate(compress) is tfed.fl_aggregate
    for compress in (True, "q8", "q8-topk", "topk"):
        _close(tsteps.make_fl_aggregate(compress, k_frac=0.3)(ts, tb, M),
               jsteps.make_fl_aggregate(compress, k_frac=0.3)(js, jb, Mj))


@pytest.mark.parametrize("method", ["trimmed_mean", "median", "krum",
                                    "norm_clip"])
def test_fl_aggregate_robust_matches_jax(method):
    stacked, base = _tree(5, seed=8)
    stacked["w"][2] += 3.0                         # one attacker
    (js, ts), (jb, tb) = _both(stacked), _both(base)
    b0 = {k: v[0] for k, v in tb.items()}
    got = tfed.fl_aggregate_robust(ts, method, base_params=b0)
    assert got["w"].shape == ts["w"].shape
    _close(got, jfed.fl_aggregate_robust(
        js, method, base_params={k: v[0] for k, v in jb.items()}))


def test_overlap_merge_clock_and_mixings_match_jax():
    a, b = _tree(3, seed=9)
    c, _ = _tree(3, seed=19)
    (ja, ta), (jb, tb), (jc, tc) = _both(a), _both(b), _both(c)
    _close(tfed.fl_overlap_merge(ta, tb, tc), jfed.fl_overlap_merge(ja, jb, jc))
    for w, sel in (([1, 2, 3], [1, 0, 1]), ([1, 1, 1], [0, 0, 0])):
        assert np.array_equal(tfed.selection_mixing(w, sel),
                              jfed.selection_mixing(w, sel))
    assert np.array_equal(tfed.async_mixing([0.2, 0.0, 0.5], [1, 0, 2]),
                          jfed.async_mixing([0.2, 0.0, 0.5], [1, 0, 2]))
    tc_, jc_ = tfed.IslandClock(4), jfed.IslandClock(4)
    for t in ([1.0, 1.1, 0.9, 3.0], [1.0, 1.0, 1.0, 2.0]):
        tc_.observe(t)
        jc_.observe(t)
        assert np.array_equal(tc_.selection(), jc_.selection())
    one = {"w": torch.arange(6.0).reshape(2, 3)}
    st = tfed.stack_islands(one, 3)
    assert st["w"].shape == (3, 2, 3) and st["w"].is_contiguous()
    assert torch.equal(tfed.island_slice(st, 2)["w"], one["w"])


def test_cohort_train_matches_jax(synmnist):
    """Two islands of flight-cnn-mnist, one epoch of 2 batches each, from
    the same params and Threefry keys: the port draws the reference's
    batch orders from the keys (1e-4: conv sum order over 2 steps)."""
    imgs, labels = synmnist
    jm = jax_build_model(jax_get_config("flight-cnn-mnist"))
    params = jm.init(jax.random.key(0))
    shards = [(imgs[i * 128:(i + 1) * 128], labels[i * 128:(i + 1) * 128])
              for i in range(2)]
    keys = jax.random.split(jax.random.key(5), 2)
    want = jfed.cohort_train(jclient.LocalTrainer(jm, lr=0.05), params,
                             shards, list(keys), 1)
    tt = tclient.LocalTrainer(build_model(get_config("flight-cnn-mnist")),
                              lr=0.05)
    got = tfed.cohort_train(tt, from_reference(params), shards,
                            list(np.asarray(jax.random.key_data(keys))), 1)
    _close(got, want, tol=1e-4)


# ---- the fog tier ----------------------------------------------------------

def _weights_cells(P, K, seed):
    rng = np.random.default_rng(seed + 100)
    weights = rng.uniform(0.1, 5.0, P)
    cell_of = rng.integers(0, K, P)
    cell_of[:K] = np.arange(K)
    return weights, cell_of


@pytest.mark.parametrize("P,K", [(6, 1), (6, 2), (8, 3), (5, 4)])
def test_mixing_matrices_and_sync_exchange_match_jax(P, K):
    weights, cell_of = _weights_cells(P, K, P * 31 + K)
    for name in ("edge_mixing_matrix", "cloud_mixing_matrix"):
        assert np.array_equal(getattr(thier, name)(weights, cell_of),
                              getattr(jhier, name)(weights, cell_of))
    assert np.array_equal(thier.flat_mixing_matrix(weights),
                          jhier.flat_mixing_matrix(weights))
    stacked, _ = _tree(P, seed=P + K)
    js, ts = _both(stacked)
    _close(thier.hierarchical_sync_aggregate(ts, weights, cell_of),
           jhier.hierarchical_sync_aggregate(js, weights, cell_of))


@pytest.mark.parametrize("compress", CMODES)
@pytest.mark.parametrize("P,K", [(6, 2), (8, 4)])
def test_two_tier_compressed_within_one_quantisation_step(compress, P, K):
    stacked, base = _tree(P, seed=P + K)
    (js, ts), (jb, tb) = _both(stacked), _both(base)
    weights, cell_of = _weights_cells(P, K, P + K)
    got = thier.hierarchical_sync_aggregate(ts, weights, cell_of,
                                            compress=compress,
                                            base_params=tb, k_frac=0.5)
    want = jhier.hierarchical_sync_aggregate(js, weights, cell_of,
                                             compress=compress,
                                             base_params=jb, k_frac=0.5)
    for k in ts:
        delta = stacked[k] - base[k]
        step = np.abs(delta).reshape(P, -1, delta.shape[-1]).max(-1).max() \
            / 127 if compress != "topk" else 0.0
        tol = step + TOL[str(got[k].dtype).removeprefix("torch.")]
        np.testing.assert_allclose(_np32(got[k]), _np32(want[k]), rtol=0,
                                   atol=tol)
    with pytest.raises(ValueError):
        thier.hierarchical_sync_aggregate(ts, weights, cell_of,
                                          compress="q8")


def _spy_grouped(monkeypatch):
    """Count the calls of the grouped quant8 ops (each is one launch per
    dtype on the card) and of their single-tensor forms."""
    from repro_torch.kernels.quant8 import ops as q8ops
    calls = {}
    for name in ("quantize_rows_grouped", "dequantize_rows_grouped",
                 "quantize_rowwise", "dequantize_rowwise"):
        real = getattr(q8ops, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*a, **kw)
        monkeypatch.setattr(q8ops, name, spy)
    return calls


@pytest.mark.parametrize("compress", ["q8", "q8_topk"])
def test_exchange_quantises_once_per_hop(monkeypatch, compress):
    """One grouped quantise and one grouped dequantise over all leaves per
    exchange hop: 1 each flat, 2 each through the fog tier; none per leaf.
    compress_tree and decompress_tree make one each for the whole tree."""
    stacked, base = _tree(6, seed=5)
    (_, ts), (_, tb) = _both(stacked), _both(base)
    weights, cell_of = _weights_cells(6, 2, 5)
    M = tfed.selection_mixing(weights, np.ones(6))
    want = {"quantize_rows_grouped": 1, "dequantize_rows_grouped": 1}
    calls = _spy_grouped(monkeypatch)
    tfed.fl_aggregate_compressed(ts, tb, M, mode=compress, k_frac=0.2)
    assert calls == want
    calls.clear()
    thier.hierarchical_sync_aggregate(ts, weights, cell_of,
                                      compress=compress, base_params=tb,
                                      k_frac=0.2)
    assert calls == {k: 2 for k in want}
    calls.clear()
    wire = tcomp.compress_tree(ts, mode=compress, k_frac=0.2)
    assert calls == {"quantize_rows_grouped": 1}
    tcomp.decompress_tree(wire)
    assert calls == want


@pytest.mark.parametrize("P,K", [(6, 2), (8, 4)])
def test_hierarchical_async_matches_jax_and_flat(P, K):
    stacked, _ = _tree(P, seed=17 + P)
    js, ts = _both(stacked)
    rng = np.random.default_rng(5 + P)
    alphas = rng.uniform(0.0, 0.9, P)
    contributors = rng.uniform(0.0, 2.0, P)
    contributors[rng.integers(0, P)] = 0.0
    _, cell_of = _weights_cells(P, K, 3 + P)
    got = thier.hierarchical_async_aggregate(ts, alphas, contributors,
                                             cell_of)
    _close(got, jhier.hierarchical_async_aggregate(js, alphas, contributors,
                                                   cell_of))
    flat = tfed.fl_aggregate(ts, jagg.async_mixing_matrix(alphas,
                                                          contributors))
    np.testing.assert_allclose(got["w"].numpy(), flat["w"].numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("robust", [None, "trimmed_mean", "median", "krum"])
def test_fog_aggregate_responses_matches_jax(robust):
    rng = np.random.default_rng(0)
    wids = [3, 5, 9, 11, 20, 21, 30]
    responses = {w: {"p": rng.normal(size=(4, 3)).astype(np.float32),
                     "q": rng.normal(size=(5,)).astype(np.float32)}
                 for w in wids}
    weights = {w: float(rng.uniform(0.5, 3.0)) for w in wids}
    for topo in (jhier.FogTopology.round_robin(wids, 2),
                 jhier.FogTopology.random(wids, 3, seed=4)):
        ttopo = thier.FogTopology(dict(topo.cell_of))
        want = jhier.fog_aggregate_responses(
            {w: jax.tree.map(jnp.asarray, r) for w, r in responses.items()},
            weights, topo, robust=robust)
        got = thier.fog_aggregate_responses(
            {w: from_reference(r) for w, r in responses.items()}, weights,
            ttopo, robust=robust)
        _close(got, want, tol=1e-6)


@pytest.mark.parametrize("method", ["trimmed_mean", "median", "krum"])
def test_hierarchical_robust_aggregate_matches_jax(method):
    stacked, _ = _tree(7, seed=12)
    js, ts = _both(stacked)
    cell_of = np.arange(7) % 3
    _close(thier.hierarchical_robust_aggregate(ts, cell_of, method),
           jhier.hierarchical_robust_aggregate(js, cell_of, method))


def test_fog_topology_helpers_match_jax():
    for n_cells in (1, 3, 4):
        for make in ("round_robin", "random"):
            kw = {"seed": 2} if make == "random" else {}
            t = getattr(thier.FogTopology, make)(range(10), n_cells, **kw)
            j = getattr(jhier.FogTopology, make)(range(10), n_cells, **kw)
            assert dict(t.cell_of) == dict(j.cell_of)
            assert t.n_cells == j.n_cells and t.cells() == j.cells()
            assert t.restrict([0, 4, 7]).cells() == \
                j.restrict([0, 4, 7]).cells()


@pytest.mark.parametrize("robust_agg", ["none", "trimmed_mean"])
def test_server_with_topology_matches_jax(robust_agg):
    """AggregationServer(topology=): sync rounds fold edge -> fog -> cloud
    (one fed_agg launch per cell and one for the cloud on the card)."""
    from test_torch_server import _assert_same, _params, _round, _servers
    jsrv, tsrv, params, rng = _servers(dict(policy="all",
                                            robust_agg=robust_agg))
    topo = jhier.FogTopology.round_robin(range(6), 2)
    jsrv.topology = topo
    tsrv.topology = thier.FogTopology(dict(topo.cell_of))
    cur = params
    for rnd in range(2):
        responses = {w: _params(rng, 0.05, cur) for w in (0, 1, 2, 4, 5)}
        _round(jsrv, tsrv, responses, float(rnd + 1))
        _assert_same(jsrv, tsrv)
        cur = to_numpy(tsrv.params)


# ---- the entry point -------------------------------------------------------

def _jax_benchmark():
    spec = importlib.util.spec_from_file_location(
        "jax_fl_exchange", ROOT / "benchmarks" / "fl_exchange.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_fl_exchange_entry_point_at_two_islands():
    """The entry point at P = 2, all four modes, flat and two-tier: the
    benchmark's tree leaf for leaf, wire MB equal to BENCH_exchange.json,
    its invariants, and the exchange's output against the JAX one."""
    bench = _jax_benchmark()
    committed = json.loads((ROOT / "BENCH_exchange.json").read_text())
    js, jb = bench.make_tree(2)
    ts, tb = fl_exchange.make_tree(2)
    _close(ts, js, tol=0.0)
    _close(tb, jb, tol=0.0)
    before = (q8kernel.quantize_grouped_cuda.launches,
              q8kernel.dequantize_grouped_cuda.launches)
    for fog_cells in (1, 2):
        cells, outputs = fl_exchange.run("cpu", islands=(2,), rounds=1,
                                         fog_cells=fog_cells)
        parity = fl_exchange.measure_parity("cpu", fog_cells=fog_cells)
        assert fl_exchange.check_invariants(cells, parity, islands=(2,)) \
            == []
        for name, cell in cells.items():
            old = committed["cells"][name]
            assert cell["wire_mb_per_round"] == old["wire_mb_per_round"]
            assert cell["reduction_vs_f32"] == old["reduction_vs_f32"]
    for mode in fl_exchange.MODES:
        # eager, as the port runs: under jit XLA may round the scale's
        # division by 127 one ulp off, moving a q by 1
        fn = jsteps.make_fl_aggregate(
            compress=False if mode == "f32" else mode, k_frac=0.05)
        M = jnp.asarray(jfed.selection_mixing(np.full(2, 0.5), np.ones(2)),
                        jnp.float32)
        want = fn(js, M) if mode == "f32" else fn(js, jb, M)
        got = fl_exchange.exchange_fn(2, mode)(ts, tb)
        _close(got, want)
    assert (q8kernel.quantize_grouped_cuda.launches,
            q8kernel.dequantize_grouped_cuda.launches) == before


def test_island_rounds_run_on_the_host():
    """The paper's model across islands (the chip check's last phase) at
    2 islands, 2 rounds: the plain path on the host, impl="ref" equal to
    impl="auto" there, params finite and moved."""
    model = build_model(get_config("flight-cnn-mnist"))
    from repro_torch import threefry
    init = model.init(threefry.key(0), "cpu")
    p1, a1 = fl_exchange.island_rounds("cpu", islands=2, rounds=2)
    p2, a2 = fl_exchange.island_rounds("cpu", islands=2, rounds=2,
                                       impl="ref")
    assert a1 == a2 and len(a1) == 2
    for k in p1:
        assert torch.equal(p1[k], p2[k])
        assert torch.isfinite(p1[k]).all()
        assert not torch.equal(p1[k], init[k])

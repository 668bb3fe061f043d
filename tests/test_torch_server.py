"""The port's AggregationServer (core/server.py, server_opt.py, the robust
aggregators) against `repro.core.server.AggregationServer` on the same
responses: params to 1e-6, quarantine counters and rejections exactly."""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import cost_model as jcm
from repro.core import server as jserver
from repro_torch.core import aggregation as tagg
from repro_torch.core import cost_model as tcm
from repro_torch.core import server as tserver
from repro_torch.models.param import from_reference, to_numpy

SHAPES = {"w": (12, 5), "b": (5,), "k": (3, 3, 2, 4)}


def _params(rng, scale=1.0, base=None):
    p = {k: (rng.normal(size=s) * scale).astype(np.float32)
         for k, s in SHAPES.items()}
    return p if base is None else {k: base[k] + p[k] for k in p}


def _servers(cfg_kw, n_workers=6, seed=0):
    rng = np.random.default_rng(seed)
    params = _params(rng)
    n_data = [64 * (1 + i % 3) for i in range(n_workers)]
    kw = dict(t_onedata_server=5e-5, server_freq=2.4e9, model_bytes=1000)
    js = {p.wid: jcm.make_stats(p, **kw)
          for p in jcm.heterogeneous_profiles(n_workers, n_data, seed=seed)}
    ts = {p.wid: tcm.make_stats(p, **kw)
          for p in tcm.heterogeneous_profiles(n_workers, n_data, seed=seed)}
    jsrv = jserver.AggregationServer(
        jax.tree.map(jnp.asarray, params), js,
        jserver.ServerConfig(**cfg_kw), seed=seed)
    tsrv = tserver.AggregationServer(
        from_reference(params), ts, tserver.ServerConfig(**cfg_kw), seed=seed)
    return jsrv, tsrv, params, rng


def _assert_same(jsrv, tsrv, tol=1e-6):
    got = to_numpy(tsrv.params)
    for k, v in jsrv.params.items():
        np.testing.assert_allclose(got[k], np.asarray(v), rtol=tol, atol=tol)
    assert tsrv.version == jsrv.version
    assert tsrv.quarantine == jsrv.quarantine
    assert tsrv.rejections == jsrv.rejections
    js, ts = jsrv.state_dict(), tsrv.state_dict()
    ej, et = js.pop("norm_ewma"), ts.pop("norm_ewma")
    assert js == ts
    assert (ej is None) == (et is None)
    if ej is not None:
        np.testing.assert_allclose(et, ej, rtol=1e-5)


def _round(jsrv, tsrv, responses, t):
    jsrv.sync_aggregate({w: jax.tree.map(jnp.asarray, p)
                         for w, p in responses.items()}, t)
    tsrv.sync_aggregate({w: from_reference(p) for w, p in responses.items()},
                        t)


@pytest.mark.parametrize("server_opt", ["avg", "avgm", "adam", "yogi"])
def test_sync_rounds_match(server_opt):
    jsrv, tsrv, params, rng = _servers(dict(policy="all",
                                            server_opt=server_opt))
    cur = params
    for rnd in range(3):
        responses = {w: _params(rng, 0.05, cur) for w in (0, 2, 3, 5)}
        _round(jsrv, tsrv, responses, 1.5 * (rnd + 1))
        _assert_same(jsrv, tsrv)
        cur = to_numpy(tsrv.params)


@pytest.mark.parametrize("method", ["trimmed_mean", "median", "krum",
                                    "norm_clip"])
@pytest.mark.parametrize("n_resp", [4, 5])
def test_robust_sync_rounds_match(method, n_resp):
    jsrv, tsrv, params, rng = _servers(dict(policy="all", robust_agg=method))
    responses = {w: _params(rng, 0.05, params) for w in range(n_resp)}
    responses[1] = _params(rng, 0.6, params)      # an attacker, not an outlier
    _round(jsrv, tsrv, responses, 2.0)
    _assert_same(jsrv, tsrv)


def test_sanitization_gate_and_quarantine_match():
    jsrv, tsrv, params, rng = _servers(dict(policy="all",
                                            quarantine_threshold=2))
    for rnd in range(3):
        responses = {w: _params(rng, 0.05, params) for w in range(6)}
        responses[1]["w"][0, 0] = np.nan                     # non-finite
        responses[4] = _params(rng, 20.0, params)           # norm outlier
        if rnd == 2:
            responses[2]["b"][1] = np.inf
        _round(jsrv, tsrv, responses, float(rnd + 1))
        _assert_same(jsrv, tsrv)
        assert tsrv.select() == jsrv.select()
    assert tsrv.quarantine == {1: 3, 4: 3, 2: 1}
    assert 1 not in tsrv.select() and 4 not in tsrv.select()
    tsrv.note_divergence(0)
    jsrv.note_divergence(0)
    _assert_same(jsrv, tsrv)


@pytest.mark.parametrize("scheme", ["polynomial", "exponential", "constant"])
def test_async_folds_match(scheme):
    jsrv, tsrv, params, rng = _servers(dict(policy="time_based", mode="async",
                                            staleness_scheme=scheme))
    base_versions = [0, 0, 1, 0, 3, 2, 5]
    for i, bv in enumerate(base_versions):
        p = _params(rng, 0.05, to_numpy(tsrv.params))
        if i == 3:
            p["k"][0, 0, 0, 0] = np.nan
        if i == 5:
            p = _params(rng, 50.0, params)
        wid = i % 4
        a = jsrv.async_fold(wid, jax.tree.map(jnp.asarray, p), bv, float(i))
        b = tsrv.async_fold(wid, from_reference(p), bv, float(i))
        assert a == b
        _assert_same(jsrv, tsrv)
        for n_rej in (1, 2, 3):
            assert tsrv.retry_policy(wid, n_rej) == \
                jsrv.retry_policy(wid, n_rej)
    assert tsrv.rejections == [(3, 3, "non_finite"), (4, 1, "norm_outlier")]


def test_policy_feedback_and_state_dict_round_trip():
    jsrv, tsrv, _, _ = _servers(dict(policy="rmin_rmax"))
    for acc in (0.1, 0.3, 0.31, 0.5):
        jsrv.record_accuracy(acc)
        tsrv.record_accuracy(acc)
        assert tsrv.select() == jsrv.select()
        assert dataclasses.asdict(tsrv.policy_state) == \
            dataclasses.asdict(jsrv.policy_state)
        for w in tsrv.select():
            assert tsrv.epochs_for(w, 3.0) == jsrv.epochs_for(w, 3.0)
    state = copy.deepcopy(tsrv.state_dict())
    _, fresh, _, _ = _servers(dict(policy="rmin_rmax"))
    fresh.load_state_dict(state)
    assert fresh.state_dict() == tsrv.state_dict()


def test_fog_topology_not_ported_yet():
    with pytest.raises(NotImplementedError):
        tserver.AggregationServer({}, {}, tserver.ServerConfig(),
                                  topology=object())
    with pytest.raises(ValueError):
        tserver.AggregationServer({}, {}, tserver.ServerConfig(
            robust_agg="mean_of_means"))


def test_mixing_matrices_match():
    from repro.core import aggregation as jagg
    w = np.array([0.1, 0.6, 0.3])
    assert np.array_equal(tagg.sync_mixing_matrix(w),
                          jagg.sync_mixing_matrix(w))
    a, c = np.array([0.0, 0.5, 0.2]), np.array([1.0, 0.0, 2.0])
    assert np.array_equal(tagg.async_mixing_matrix(a, c),
                          jagg.async_mixing_matrix(a, c))
    for scheme in ("uniform", "fedavg", "linear", "polynomial",
                   "exponential"):
        assert np.array_equal(
            tagg.aggregation_weights(scheme, [10, 20, 30], [0, 1, 5]),
            jagg.aggregation_weights(scheme, [10, 20, 30], [0, 1, 5]))
    for s in (0, 1, 4):
        for scheme in ("polynomial", "exponential", "constant"):
            assert tagg.staleness_alpha(0.6, s, scheme=scheme) == \
                jagg.staleness_alpha(0.6, s, scheme=scheme)
    for P in range(1, 9):
        assert tagg.trim_k(P, 0.2) == jagg.trim_k(P, 0.2)

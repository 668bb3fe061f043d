"""The port's fault injection (core/faults.py) and the event engine's
`faults=` against the JAX package: every FaultPlan decision exactly, the
corruptions within 1e-6 (the same numpy draws), `finite_members` exactly,
and FLSimulation(faults=...) with time / round / n_selected / version
columns exact and accuracy within 0.01 over its first merges."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import faults as jfaults
from repro_torch.core import faults as tfaults
from repro_torch.models.param import from_reference
from repro_torch.tree import leaves

PARAMS = {"w": np.linspace(-1, 1, 12, dtype=np.float32).reshape(4, 3),
          "b": np.arange(5, dtype=np.float32)}
BASE = {"w": np.full((4, 3), 0.5, np.float32),
        "b": np.full((5,), -0.5, np.float32)}
CONFIGS = [dict(byzantine_frac=0.3, drop_frac=0.2, duplicate_frac=0.1,
                seed=5),
           dict(byzantine_frac=0.5, attacks=("nan", "noise", "stale"),
                worker_crash_frac=0.25, drop_frac=0.1, seed=11),
           dict(server_crash_rounds=(3, 7), seed=2)]


def _plans(**kw):
    return jfaults.FaultPlan(jfaults.FaultConfig(**kw)), \
        tfaults.FaultPlan(tfaults.FaultConfig(**kw))


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


@pytest.mark.parametrize("cfg", range(len(CONFIGS)))
def test_plan_decisions_match_jax(cfg):
    j, t = _plans(**CONFIGS[cfg])
    for w in range(40):
        assert t.is_byzantine(w) == j.is_byzantine(w)
        assert t.attack_for(w) == j.attack_for(w)
        for r in range(6):
            assert t.response_fate(w, r) == j.response_fate(w, r)
    assert [r for r in range(10) if t.server_crashes(r)] == \
        [r for r in range(10) if j.server_crashes(r)]
    assert t.byzantine_in(range(40)) == j.byzantine_in(range(40))
    with pytest.raises(ValueError):
        tfaults.FaultPlan(tfaults.FaultConfig(attacks=("gradient_surgery",)))
    assert tfaults.ATTACKS == jfaults.ATTACKS


@pytest.mark.parametrize("attack", list(jfaults.ATTACKS))
def test_corrupt_matches_jax(attack):
    j, t = _plans(byzantine_frac=1.0, attacks=(attack,), scale_factor=7.0,
                  noise_std=0.3, nonfinite_frac=0.2, seed=4)
    want = j.corrupt(_jax(PARAMS), _jax(BASE), 3, 2)
    got = t.corrupt(from_reference(PARAMS), from_reference(BASE), 3, 2)
    for g, w in zip(leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)          # NaN/inf in place
    honest = from_reference(PARAMS)
    _, t0 = _plans(byzantine_frac=0.0)
    assert t0.corrupt(honest, from_reference(BASE), 1, 0) is honest


def test_corrupt_stacked_and_finite_members_match_jax():
    j, t = _plans(byzantine_frac=0.5, attacks=("sign_flip", "nan"), seed=9)
    stacked = {k: np.stack([v * (i + 1) for i in range(6)])
               for k, v in PARAMS.items()}
    wids = [10, 11, 12, 13, 14, 15]
    assert j.byzantine_in(wids)                   # someone attacks
    ts = from_reference(stacked)
    want = j.corrupt_stacked(_jax(stacked), _jax(BASE), wids, 1)
    got = t.corrupt_stacked(ts, from_reference(BASE), wids, 1)
    for g, w in zip(leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    np.testing.assert_array_equal(tfaults.finite_members(got),
                                  jfaults.finite_members(want))
    assert torch.equal(ts["w"], torch.from_numpy(stacked["w"]))  # untouched
    assert tfaults.finite_members({}).shape == (0,)


def _fault_sims(synmnist, synmnist_test, faults, **kw):
    from test_torch_events import _sims
    jsim, tsim = _sims(synmnist, synmnist_test, **kw)
    jsim.faults = jfaults.FaultPlan(jfaults.FaultConfig(**faults))
    tsim.faults = tfaults.FaultPlan(tfaults.FaultConfig(**faults))
    return jsim, tsim


def _assert_records_match(jres, tres):
    cols = lambda res: [(r.time, r.round, r.n_selected, r.version)
                        for r in res.records]
    assert cols(tres) == cols(jres)
    np.testing.assert_allclose([r.acc for r in tres.records],
                               [r.acc for r in jres.records], atol=0.01)
    assert tres.crashed == jres.crashed


def test_sync_run_with_faults_matches_jax(synmnist, synmnist_test):
    """Byzantine sign flips and NaN sprays, dropped responses and a server
    crash in round 3 of 4, on the 3-worker fleet: the sanitization gate,
    quarantine and crash end the run exactly as JAX's does."""
    faults = dict(byzantine_frac=0.5, attacks=("sign_flip", "nan"),
                  drop_frac=0.2, server_crash_rounds=(3,), seed=7)
    jsim, tsim = _fault_sims(synmnist, synmnist_test, faults, policy="all",
                             mode="sync", epochs=1)
    assert jsim.faults.byzantine_in(range(3)) == [0, 2]
    jres, tres = jsim.run_sync(rounds=4), tsim.run_sync(rounds=4)
    assert tres.crashed and len(tres.records) == 3
    _assert_records_match(jres, tres)
    assert tsim.server.quarantine == jsim.server.quarantine
    assert (1, 2, "non_finite") in tsim.server.rejections
    assert tsim.server.rejections == jsim.server.rejections


def test_async_run_with_faults_matches_jax(synmnist, synmnist_test):
    """Drops, re-deliveries and Byzantine updates through 8 async merges:
    duplicates fold twice, rejections go through retry/backoff."""
    faults = dict(byzantine_frac=0.34, attacks=("scale", "inf"),
                  drop_frac=0.15, duplicate_frac=0.25, seed=3)
    jsim, tsim = _fault_sims(synmnist, synmnist_test, faults,
                             policy="all", mode="async", epochs=1)
    jres = jsim.run_async(max_merges=8)
    tres = tsim.run_async(max_merges=8)
    assert tres.records[-1].round == 8 and not tres.crashed
    _assert_records_match(jres, tres)
    assert tsim.server.rejections == jsim.server.rejections
    assert {why for _, _, why in tsim.server.rejections} == \
        {"non_finite", "norm_outlier"}
    assert tsim.server.version == jsim.server.version

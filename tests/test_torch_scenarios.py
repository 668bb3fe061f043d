"""The population-scale scenario engine on the port (core/scenarios.py)
against `repro.core.scenarios.ScenarioSim` on the same configs: shards,
population and churn exactly; the time / round / n_selected / version
columns and quarantine counts exactly; accuracy within 0.01 record for
record and final sync params within 1e-3 when both start from the JAX
run's params; the reference's semantics tests on the port; resume bit for
bit, and checkpoints crossing between the packages; the fl_scale /
fl_faults examples' constants against the JAX benchmarks'.

  PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_scenarios.py

prints the JAX engine's readings that chip_smoke.py holds the card to:
each fl_scale cell's record stream and best accuracy, fl_faults' cells,
each from its own initial params and from every param one ulp up and one
ulp down (the tolerance is twice the largest shift of best accuracy).
"""
import dataclasses
import json
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:       # the JAX harness is the repo's
    sys.path.insert(0, str(ROOT))   # top-level `benchmarks` package

from benchmarks import fl_faults as jfl_faults
from benchmarks import fl_scale as jfl_scale
from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.core import scenarios as jscen
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import scenarios as tscen
from repro_torch.core.aggregation import tree_finite
from repro_torch.examples import (fl_faults, fl_scale, profile_scenarios,
                                  resume)
from repro_torch.models.param import from_reference

BASE = dict(n_workers=256, cohort_size=8, participation=0.25, epochs=1,
            samples_per_worker=64, seed=7)
DYNAMIC = dict(churn_leave=0.05, churn_join=0.05, straggler_frac=0.1,
               drift=0.4, dirichlet_alpha=0.5)
# tests/test_resume.py's scenario fleet (examples/resume.py's SCENARIO)
RESUME = dict(n_workers=40, cohort_size=6, fog_cells=2, participation=0.4,
              samples_per_worker=32, byzantine_frac=0.25,
              byzantine_scale=8.0, robust_agg="trimmed_mean", trim_frac=0.3,
              seed=5)
ACC_TOL = 0.01          # accuracy, record for record, same initial params
PARAM_TOL = 1e-3        # final sync params (tests/test_torch_events.py)


def cols(res):
    return [(r.time, r.round, r.n_selected, r.version) for r in res.records]


def accs(res):
    return [r.acc for r in res.records]


class _FromJax:
    """A port model whose `init` returns the JAX model's params for the
    same key: both engines then start from identical weights."""

    def __init__(self, tmodel, jmodel):
        self._t, self._j = tmodel, jmodel

    def init(self, key, device="cuda"):
        jparams = self._j.init(jax.random.wrap_key_data(
            jnp.asarray(key, jnp.uint32)))
        return from_reference(jax.tree.map(np.asarray, jparams), device)

    def __getattr__(self, name):
        return getattr(self._t, name)


def pair(knobs: dict, **kw):
    """(JAX sim, port sim on the CPU starting from the JAX params)."""
    jsim = jscen.ScenarioSim(jscen.ScenarioConfig(**knobs), **kw)
    tsim = tscen.ScenarioSim(tscen.ScenarioConfig(**knobs), device="cpu",
                             **kw)
    tsim.model = _FromJax(tsim.model, jsim.model)
    return jsim, tsim


def assert_params_close(tparams, jparams, atol=PARAM_TOL):
    for k, v in jparams.items():
        if isinstance(v, dict):
            assert_params_close(tparams[k], v, atol)
        else:
            np.testing.assert_allclose(tparams[k].numpy(), np.asarray(v),
                                       rtol=0, atol=atol)


# -- config, data, population ----------------------------------------------

def test_config_and_default_model_are_the_references():
    jf, tf = (dataclasses.fields(c) for c in
              (jscen.ScenarioConfig, tscen.ScenarioConfig))
    assert [(f.name, f.default) for f in tf] == \
        [(f.name, f.default) for f in jf]
    assert dataclasses.asdict(tscen._DEFAULT_MODEL) == \
        dataclasses.asdict(jscen._DEFAULT_MODEL)


def test_shard_for_matches_jax():
    """Drift rotates a Dirichlet label skew: shards equal for several
    workers and rounds, IID and skewed."""
    for knobs in (BASE, {**BASE, "dirichlet_alpha": 0.3, "drift": 1.0},
                  {**BASE, **DYNAMIC}):
        jsim, tsim = pair(knobs)
        for wid in (0, 3, 101, 255):
            for rnd in (0, 1, 5, 12):
                jx, jy = jsim.shard_for(wid, rnd)
                tx, ty = tsim.shard_for(wid, rnd)
                np.testing.assert_array_equal(tx, jx)
                np.testing.assert_array_equal(ty, jy)


def test_population_and_churn_match_jax():
    jsim, tsim = pair({**BASE, **DYNAMIC, "churn_leave": 0.3})
    np.testing.assert_array_equal(tsim.t_one, jsim.t_one)
    np.testing.assert_array_equal(tsim.t_tx, jsim.t_tx)
    for _ in range(4):
        jsim._churn()
        tsim._churn()
        np.testing.assert_array_equal(tsim.alive, jsim.alive)
        np.testing.assert_array_equal(tsim._select(), jsim._select())
    assert tsim.alive.sum() < 256
    np.testing.assert_array_equal(tsim.key, np.asarray(
        jax.random.key_data(jsim.key)))
    for _ in range(3):
        np.testing.assert_array_equal(tsim._next_key(), np.asarray(
            jax.random.key_data(jsim._next_key())))


# -- the engine against JAX -------------------------------------------------

def test_run_sync_matches_jax():
    jsim, tsim = pair({**BASE, **DYNAMIC})
    jres, tres = jsim.run_sync(3), tsim.run_sync(3)
    assert cols(tres) == cols(jres)
    np.testing.assert_allclose(accs(tres), accs(jres), atol=ACC_TOL)
    assert_params_close(tres.final_params, jres.final_params)


def test_run_async_matches_jax():
    jsim, tsim = pair({**BASE, **DYNAMIC})
    jres, tres = jsim.run_async(16), tsim.run_async(16)
    assert len(tres.records) == 17
    assert cols(tres) == cols(jres)
    np.testing.assert_allclose(accs(tres), accs(jres), atol=ACC_TOL)


@pytest.mark.parametrize("method", ["trimmed_mean", "median", "krum",
                                    "norm_clip"])
def test_robust_fold_matches_jax(method):
    """One round of a 25 %-Byzantine cohort through 2 fog cells, folded
    by each robust aggregator."""
    jsim, tsim = pair({**BASE, "fog_cells": 2, "byzantine_frac": 0.25,
                       "robust_agg": method, "trim_frac": 0.3})
    jres, tres = jsim.run_sync(1), tsim.run_sync(1)
    assert cols(tres) == cols(jres)
    np.testing.assert_allclose(accs(tres), accs(jres), atol=ACC_TOL)
    assert_params_close(tres.final_params, jres.final_params)


def test_nonfinite_attack_quarantine_matches_jax():
    """tests/test_faults.py's nan/inf spray: the same members rejected,
    the published model finite."""
    jsim, tsim = pair(dict(n_workers=40, cohort_size=6, fog_cells=2,
                           participation=0.4, samples_per_worker=32,
                           byzantine_frac=0.5,
                           byzantine_attacks=("nan", "inf"), seed=1),
                      pool=256, eval_n=128)
    jres, tres = jsim.run_sync(3), tsim.run_sync(3)
    assert tsim.quarantine and tsim.quarantine == jsim.quarantine
    assert cols(tres) == cols(jres)
    assert tree_finite(tres.final_params)


def test_robust_beats_fedavg_under_attack():
    """tests/test_faults.py's end-to-end check on the port."""
    base = dict(n_workers=120, cohort_size=10, fog_cells=1,
                participation=0.25, samples_per_worker=96, epochs=2,
                byzantine_frac=0.2, byzantine_scale=10.0, seed=3)
    attacked = tscen.ScenarioSim(tscen.ScenarioConfig(**base), pool=1024,
                                 eval_n=256, device="cpu").run_sync(8)
    robust = tscen.ScenarioSim(tscen.ScenarioConfig(
        **base, robust_agg="trimmed_mean", trim_frac=0.3), pool=1024,
        eval_n=256, device="cpu").run_sync(8)
    assert robust.best_acc >= attacked.best_acc
    assert tree_finite(robust.final_params)


# -- the reference's semantics tests, on the port ----------------------------

def _sim(**knobs):
    return tscen.ScenarioSim(tscen.ScenarioConfig(**knobs), device="cpu")


def _deterministic(mode):
    run = (lambda s: s.run_sync(4)) if mode == "sync" else \
        (lambda s: s.run_async(16))
    r1, r2 = (run(_sim(**BASE, **DYNAMIC)) for _ in range(2))
    assert [(*c, a) for c, a in zip(cols(r1), accs(r1))] == \
        [(*c, a) for c, a in zip(cols(r2), accs(r2))]


def _partial_participation():
    r = _sim(**BASE).run_sync(3)
    assert all(rec.n_selected == int(round(0.25 * 256))
               for rec in r.records[1:])


def _churn():
    sim = _sim(**{**BASE, "seed": 11}, churn_leave=0.3)
    n_sel = [rec.n_selected for rec in sim.run_sync(5).records[1:]]
    assert n_sel[-1] < n_sel[0]          # fleet bleeds out
    assert sim.alive.sum() < 256
    sim2 = _sim(**{**BASE, "seed": 11}, churn_leave=0.3, churn_join=0.3)
    sim2.run_sync(5)
    assert sim2.alive.sum() > sim.alive.sum()


def _stragglers():
    fast = _sim(**BASE).run_sync(3)
    slow = _sim(**BASE, straggler_frac=0.2, straggler_slow=10.0).run_sync(3)
    assert slow.records[-1].time > 2 * fast.records[-1].time


def _drift():
    sim = _sim(**BASE, dirichlet_alpha=0.3, drift=1.0)
    _, y0 = sim.shard_for(3, 0)
    _, y5 = sim.shard_for(3, 5)
    h0 = np.bincount(y0, minlength=10) / len(y0)
    h5 = np.bincount(y5, minlength=10) / len(y5)
    assert np.abs(h0 - 0.1).max() > 0.1
    assert np.abs(h0 - h5).max() > 0.1
    np.testing.assert_allclose(
        np.roll(np.bincount(y0, minlength=10), 5),
        np.bincount(y5, minlength=10), atol=len(y0) * 0.2)


LEARN = dict(n_workers=256, cohort_size=16, participation=0.5, epochs=2,
             samples_per_worker=128, seed=0)


def _sync_learns():
    r = _sim(**LEARN).run_sync(10)
    assert r.best_acc > 0.5
    times = [rec.time for rec in r.records]
    assert all(b > a for a, b in zip(times, times[1:]))


def _async_learns():
    r = _sim(**LEARN).run_async(120)
    assert r.best_acc > 0.35
    assert all(rec.n_selected <= 1 for rec in r.records[1:])


def _fog_cells():
    one = _sim(**BASE, fog_cells=1).run_sync(3)
    four = _sim(**BASE, fog_cells=4).run_sync(3)
    np.testing.assert_allclose(accs(one), accs(four), atol=1e-3)
    assert [r.time for r in one.records] == [r.time for r in four.records]


SEMANTICS = {"sync_deterministic": lambda: _deterministic("sync"),
             "async_deterministic": lambda: _deterministic("async"),
             "partial_participation": _partial_participation,
             "churn_shrinks_and_recovers": _churn,
             "stragglers_stretch_round_time": _stragglers,
             "drift_rotates_label_skew": _drift,
             "sync_learns_iid": _sync_learns,
             "async_learns_iid": _async_learns,
             "fog_cells_match_single_cell": _fog_cells}


@pytest.mark.parametrize("case", list(SEMANTICS))
def test_reference_semantics_on_port(case):
    """tests/test_scenarios.py's determinism and semantics cases."""
    SEMANTICS[case]()


# -- crash-safe resume ------------------------------------------------------

def _resume_run(sim, mode, **kw):
    n = resume.SCENARIO_RUN_LEN[mode]
    return sim.run_sync(n, **kw) if mode == "sync" else \
        sim.run_async(n, **kw)


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_resume_is_bit_identical(tmp_path, mode):
    """tests/test_resume.py's scenario case: killed + resumed ==
    uninterrupted, records and final params exactly."""
    ref, killed, resumed, merges = resume.scenario_crash_and_resume(
        mode, tmp_path, "cpu")
    assert len(killed.records) < len(ref.records)
    assert resume.holds(ref, killed, resumed)
    # uninterrupted + killed (its fatal round included) + resumed
    assert merges == {"sync": 4 + 2 + 3, "async": 8 + 5 + 4}[mode]
    assert dataclasses.asdict(resume.SCENARIO) == \
        dataclasses.asdict(jscen.ScenarioConfig(**RESUME))


@pytest.mark.parametrize("mode", ["sync", "async"])
@pytest.mark.parametrize("crashes_in", ["jax", "port"])
def test_checkpoint_crosses_packages(tmp_path, mode, crashes_in):
    """A run killed in one package resumes in the other: the key, the
    bool `alive` leaf (churn on, so it has holes), the numpy stream, the
    heap and the in-flight members cross; the joined stream equals the
    uninterrupted one in its columns exactly and in accuracy within
    0.01."""
    knobs = {**RESUME, "churn_leave": 0.1, "churn_join": 0.05}
    crashing = {**knobs, "server_crash_round":
                resume.SCENARIO_CRASH_AT[mode]}
    kw = dict(pool=256, eval_n=128)
    ref_sim = pair(knobs, **kw)[0]
    ref = _resume_run(ref_sim, mode)
    managers = {"jax": JaxCheckpointManager(str(tmp_path)),
                "port": CheckpointManager(tmp_path)}
    other = "port" if crashes_in == "jax" else "jax"
    side = {"jax": 0, "port": 1}
    killed = pair(crashing, **kw)[side[crashes_in]]
    killed.ckpt = managers[crashes_in]
    r1 = _resume_run(killed, mode)
    assert r1.crashed
    fresh = pair(crashing, **kw)[side[other]]
    fresh.ckpt = managers[other]
    r2 = _resume_run(fresh, mode, resume=True)
    assert not r2.crashed
    joined = r1.records + r2.records
    assert [(r.time, r.round, r.n_selected, r.version) for r in joined] == \
        cols(ref)
    np.testing.assert_allclose([r.acc for r in joined], accs(ref),
                               atol=ACC_TOL)
    assert not fresh.alive.all()
    np.testing.assert_array_equal(fresh.alive, ref_sim.alive)
    assert fresh.quarantine == ref_sim.quarantine


# -- the workloads ------------------------------------------------------------

def test_example_constants_are_the_benchmarks():
    for n in (1_000, 100_000):
        assert dataclasses.asdict(fl_scale.scenario(n)) == \
            dataclasses.asdict(jfl_scale.scenario(n))
    assert fl_scale.WORKERS == (1_000, 100_000)
    assert (fl_scale.SYNC_ROUNDS, fl_scale.ASYNC_MERGES) == \
        (jfl_scale.SYNC_ROUNDS, jfl_scale.ASYNC_MERGES)
    for name in ("BASE", "ATTACK", "CELLS", "ROUNDS", "ACC_TOL",
                 "DEGRADE_MIN"):
        assert getattr(fl_faults, name) == getattr(jfl_faults, name), name


def test_fault_invariants_judge_as_the_benchmark():
    committed = json.loads((ROOT / "BENCH_faults.json").read_text())
    weak = json.loads(json.dumps(committed))
    weak["cells"]["attacked_fedavg"]["best_acc"] = 0.9
    weak["cells"]["attacked_krum"]["params_finite"] = False
    for result in (committed, weak):
        assert fl_faults.check_invariants(result) == \
            jfl_faults.check_invariants(result)
    assert fl_faults.check_invariants(committed) == []


def test_fl_scale_cells_match_jax_at_1000_workers():
    """fl_scale's 10^3-worker cells through the example's `run_cell`:
    record streams equal to the JAX engine's (its digest too), no
    fed_agg launch on the CPU."""
    for mode in ("sync", "async"):
        jsim = jscen.ScenarioSim(jfl_scale.scenario(1_000))
        jres = jsim.run_sync(jfl_scale.SYNC_ROUNDS) if mode == "sync" else \
            jsim.run_async(jfl_scale.ASYNC_MERGES)
        tres, wall, launches = fl_scale.run_cell(1_000, mode, "cpu")
        assert cols(tres) == cols(jres) and wall > 0 and launches == 0
        assert fl_scale.stream_digest(tres) == fl_scale.stream_digest(jres)
        assert abs(tres.best_acc - jres.best_acc) <= ACC_TOL


def test_profile_breakdown_covers_the_loop():
    """profile_scenarios' layers on the CPU at 10^3 workers: every layer
    of the loop timed, self times adding up to the wall."""
    bucket = profile_scenarios.breakdown(1_000, torch.device("cpu"))
    for label in ("population", "shards", "orders", "copy", "training",
                  "fold", "merge", "evaluation"):
        assert bucket[label] > 0, label
    parts = sum(v for k, v in bucket.items() if k != "total")
    assert abs(parts - bucket["total"]) < 1e-6


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tscen.ScenarioSim(tscen.ScenarioConfig(**BASE))


# -- the 10^5 suite (scale marker: not tier-1) ------------------------------

SCALE = dict(n_workers=100_000, cohort_size=16, participation=0.05,
             churn_leave=0.02, churn_join=0.02, straggler_frac=0.05,
             straggler_slow=8.0, drift=0.3, dirichlet_alpha=0.5,
             epochs=1, samples_per_worker=64, seed=1)
SCALE_BOUND_S = 90.0


@pytest.mark.scale
def test_scale_sync_churn_straggler_noniid_under_bound():
    t0 = time.monotonic()
    sim = _sim(**SCALE)
    r = sim.run_sync(5)
    assert time.monotonic() - t0 < SCALE_BOUND_S
    assert all(3500 < rec.n_selected < 6500 for rec in r.records[1:])
    assert r.records[1].time > float(np.min(sim.t_one))
    assert r.best_acc > 0.1
    times = [rec.time for rec in r.records]
    assert all(b > a for a, b in zip(times, times[1:]))


@pytest.mark.scale
def test_scale_async_churn_straggler_noniid_under_bound():
    t0 = time.monotonic()
    r = _sim(**SCALE).run_async(64)
    assert time.monotonic() - t0 < SCALE_BOUND_S
    assert len(r.records) == 65
    assert r.best_acc > 0.1
    times = [rec.time for rec in r.records]
    assert all(b >= a for a, b in zip(times, times[1:]))


@pytest.mark.scale
def test_scale_deterministic_and_equal_to_jax():
    cfg = {**SCALE, "seed": 2}
    r1, r2 = _sim(**cfg).run_sync(3), _sim(**cfg).run_sync(3)
    assert [(*c, a) for c, a in zip(cols(r1), accs(r1))] == \
        [(*c, a) for c, a in zip(cols(r2), accs(r2))]
    assert cols(r1) == cols(jscen.ScenarioSim(
        jscen.ScenarioConfig(**cfg)).run_sync(3))


# -- the JAX readings chip_smoke.py holds the card to -------------------------

class _Nudged:
    """A JAX model whose initial params are every one one ulp toward
    `direction` (np.nextafter)."""

    def __init__(self, model, direction: float):
        self._m, self._d = model, direction

    def init(self, key):
        return jax.tree.map(lambda p: jnp.nextafter(
            p, jnp.asarray(self._d, p.dtype)), self._m.init(key))

    def __getattr__(self, name):
        return getattr(self._m, name)


def jax_readings(nudge: float = 0.0) -> dict:
    """{cell: (best_acc, digest, n_records, last record)} for fl_scale's
    four cells and {cell: (best_acc, n_quarantined)} for fl_faults' six,
    from the JAX engine with initial params nudged by one ulp (0: own)."""
    def sim(cfg, **kw):
        s = jscen.ScenarioSim(cfg, **kw)
        if nudge:
            s.model = _Nudged(s.model, nudge)
        return s
    out = {}
    for n in fl_scale.WORKERS:
        for mode in ("sync", "async"):
            s = sim(jfl_scale.scenario(n))
            r = s.run_sync(jfl_scale.SYNC_ROUNDS) if mode == "sync" else \
                s.run_async(jfl_scale.ASYNC_MERGES)
            last = r.records[-1]
            out[f"{mode}_n{n}"] = (r.best_acc, fl_scale.stream_digest(r),
                                   len(r.records), (last.time, last.round,
                                                    last.n_selected,
                                                    last.version))
    for name, knobs in jfl_faults.CELLS.items():
        s = sim(jscen.ScenarioConfig(**jfl_faults.BASE, **knobs), pool=2048,
                eval_n=512)
        r = s.run_sync(jfl_faults.ROUNDS)
        out[name] = (r.best_acc, len(s.quarantine))
    return out


if __name__ == "__main__":
    runs = {label: jax_readings(n) for label, n in
            (("own", 0.0), ("one ulp up", np.inf),
             ("one ulp down", -np.inf))}
    shift = 0.0
    for cell, own in runs["own"].items():
        print(f"{cell}: " + "; ".join(f"{label} {r[cell]}"
                                      for label, r in runs.items()))
        if cell != "attacked_fedavg" and cell != "attacked_nonfinite":
            shift = max([shift] + [abs(r[cell][0] - own[0])
                                   for r in runs.values()])
    print(f"largest best_acc shift (fl_scale cells, fl_faults clean and "
          f"robust cells): {shift}; tolerance {2 * shift}")

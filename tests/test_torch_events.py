"""The slice as a whole: the port's discrete-event engine (core/events.py)
against `repro.core.events.FLSimulation` on one fleet.  Both engines draw
the same numpy timing stream and the same Threefry batch orders, so the
time / round / n_selected / version columns are equal exactly and accuracy
agrees within 0.01."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.configs import get_config as jax_get_config
from repro.core import client as jclient
from repro.core import cost_model as jcm
from repro.core import events as jevents
from repro.core import server as jserver
from repro.data.partition import partition_by_batches
from repro.data.synthetic import make_classification_set
from repro.models import build_model as jax_build_model
from repro_torch import threefry
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core import client as tclient
from repro_torch.core import cost_model as tcm
from repro_torch.core import events as tevents
from repro_torch.core import server as tserver
from repro_torch.examples import quickstart
from repro_torch.kernels.fed_agg.kernel import fed_agg_grouped_cuda
from repro_torch.models import build_model
from repro_torch.models.param import from_reference

ARCH = "flight-cnn-mnist"


def _sims(synmnist, synmnist_test, *, policy, mode, epochs, seed=0):
    imgs, labels = synmnist
    shards = partition_by_batches(imgs, labels, [2, 1, 1], batch_size=64,
                                  seed=seed)
    n_data = [s[0].shape[0] for s in shards]
    jm = jax_build_model(jax_get_config(ARCH))
    params = jm.init(jax.random.key(seed))
    model_bytes = 4 * jm.n_params
    ti, tl = synmnist_test[0][:256], synmnist_test[1][:256]
    cfg = dict(policy=policy, mode=mode, epochs_per_round=epochs)
    kw = dict(t_onedata_server=5e-5, server_freq=2.4e9,
              model_bytes=model_bytes)
    sim_kw = dict(t_per_sample_ref=5e-5, model_bytes=model_bytes, seed=seed)

    jt = jclient.LocalTrainer(jm, lr=0.05, batch_size=64)
    jprof = jcm.heterogeneous_profiles(3, n_data, seed=seed)
    jsim = jevents.FLSimulation(
        jserver.AggregationServer(params, {p.wid: jcm.make_stats(p, **kw)
                                           for p in jprof},
                                  jserver.ServerConfig(**cfg), seed=seed),
        {i: jclient.SimWorker(i, x, y, jt, p)
         for i, (p, (x, y)) in enumerate(zip(jprof, shards))},
        ti, tl, **sim_kw)

    tt = tclient.LocalTrainer(build_model(get_config(ARCH)), lr=0.05,
                              batch_size=64)
    tprof = tcm.heterogeneous_profiles(3, n_data, seed=seed)
    tsim = tevents.FLSimulation(
        tserver.AggregationServer(from_reference(params),
                                  {p.wid: tcm.make_stats(p, **kw)
                                   for p in tprof},
                                  tserver.ServerConfig(**cfg), seed=seed),
        {i: tclient.SimWorker(i, x, y, tt, p)
         for i, (p, (x, y)) in enumerate(zip(tprof, shards))},
        ti, tl, **sim_kw)
    return jsim, tsim


def jax_quickstart(seed=0, params=None):
    """The JAX package's examples/quickstart.py run (which fixes seed 0) at
    `seed`: 5 workers, Alg. 2 selection, async merges; `params` replaces
    the initial params drawn from `seed`."""
    model = jax_build_model(jax_get_config(ARCH))
    images, labels = make_classification_set("synmnist", 8192, seed=seed)
    shards = partition_by_batches(images, labels, [4, 2, 2, 1, 1],
                                  batch_size=64)
    profiles = jcm.heterogeneous_profiles(5, [s[0].shape[0] for s in shards],
                                          seed=seed)
    if params is None:
        params = model.init(jax.random.key(seed))
    model_bytes = 4 * model.n_params
    trainer = jclient.LocalTrainer(model, lr=0.05, batch_size=64)
    workers = {i: jclient.SimWorker(i, x, y, trainer, p)
               for i, (p, (x, y)) in enumerate(zip(profiles, shards))}
    stats = {i: jcm.make_stats(p, t_onedata_server=5e-5, server_freq=2.4e9,
                               model_bytes=model_bytes)
             for i, p in enumerate(profiles)}
    server = jserver.AggregationServer(params, stats, jserver.ServerConfig(
        policy="time_based", mode="async", epochs_per_round=4))
    test_i, test_l = make_classification_set("synmnist", 1024, seed=9)
    return jevents.FLSimulation(server, workers, test_i, test_l,
                                t_per_sample_ref=5e-5,
                                model_bytes=model_bytes, seed=seed)


def _assert_records_match(jres, tres):
    cols = lambda res: [(r.time, r.round, r.n_selected, r.version)
                        for r in res.records]
    assert cols(tres) == cols(jres)
    np.testing.assert_allclose([r.acc for r in tres.records],
                               [r.acc for r in jres.records], atol=0.01)


def test_run_sync_all_matches_jax(synmnist, synmnist_test):
    """3 rounds, every worker: the two 64-sample shards train as a vmapped
    cohort, the 128-sample one alone."""
    jsim, tsim = _sims(synmnist, synmnist_test, policy="all", mode="sync",
                       epochs=2)
    jres, tres = jsim.run_sync(rounds=3), tsim.run_sync(rounds=3)
    assert [r.n_selected for r in tres.records] == [0, 3, 3, 3]
    _assert_records_match(jres, tres)
    assert tres.best_acc > tres.records[0].acc
    for k, v in jres.final_params.items():
        np.testing.assert_allclose(tres.final_params[k].numpy(),
                                   np.asarray(v), rtol=0, atol=1e-3)


def test_run_async_time_based_matches_jax(synmnist, synmnist_test):
    """Alg. 2 from its cold start (T = 0: idle ticks until accuracy stalls)
    through 10 staleness-weighted merges."""
    jsim, tsim = _sims(synmnist, synmnist_test, policy="time_based",
                       mode="async", epochs=1, seed=1)
    jres = jsim.run_async(max_merges=10)
    tres = tsim.run_async(max_merges=10)
    assert tres.records[-1].round == 10
    assert any(r.n_selected == 0 for r in tres.records[1:])  # idle ticks
    _assert_records_match(jres, tres)
    assert tsim.server.version == jsim.server.version


def test_cohort_off_matches_cohort_on(synmnist, synmnist_test):
    _, on = _sims(synmnist, synmnist_test, policy="all", mode="sync",
                  epochs=1)
    _, off = _sims(synmnist, synmnist_test, policy="all", mode="sync",
                   epochs=1)
    off.cohort = False
    r_on, r_off = on.run_sync(rounds=2), off.run_sync(rounds=2)
    assert [r.time for r in r_on.records] == [r.time for r in r_off.records]
    np.testing.assert_allclose([r.acc for r in r_on.records],
                               [r.acc for r in r_off.records], atol=1e-3)


def test_as_arrays_and_ckpt_every_match_jax(synmnist, synmnist_test,
                                            tmp_path):
    """`SimResult.as_arrays()` gives the reference's (time, accuracy)
    arrays for the same 2 sync rounds, and `ckpt_every=` with `ckpt=`
    checkpoints the rounds the reference's does (every third)."""
    jsim, tsim = _sims(synmnist, synmnist_test, policy="all", mode="sync",
                       epochs=1)
    (jt, ja), (tt, ta) = (jsim.run_sync(rounds=2).as_arrays(),
                          tsim.run_sync(rounds=2).as_arrays())
    assert tt.shape == ta.shape == jt.shape == (3,)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(ta, ja, atol=0.01)
    ti, tl = synmnist_test[0][:256], synmnist_test[1][:256]
    sim = tevents.FLSimulation(tsim.server, tsim.workers, ti, tl,
                               ckpt_every=3)
    assert sim.ckpt_every == 3 and sim.ckpt is None
    steps = {}
    for name, sim in (("jax", jsim), ("port", tsim)):
        mgr = (JaxCheckpointManager if name == "jax" else
               CheckpointManager)(tmp_path / name)
        sim.ckpt, sim.ckpt_every = mgr, 3
        sim.run_sync(rounds=7)
        steps[name] = mgr.all_steps()
    assert steps["port"] == steps["jax"] == [3, 6]


def test_quickstart_runs_on_cpu_and_matches_jax():
    """The port's entry point from the same seed as the JAX quickstart:
    the same initial params (to a few ulp), the same batch orders and the
    same timing draws, so the first merges agree record for record."""
    before = fed_agg_grouped_cuda.launches
    tres = quickstart.run("cpu", max_merges=12)
    assert fed_agg_grouped_cuda.launches == before   # host tensors: plain version
    assert tres.records[-1].round == 12
    assert all(r.n_selected <= 1 for r in tres.records[1:])
    _assert_records_match(jax_quickstart(0).run_async(max_merges=12), tres)


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        quickstart.run()
    with pytest.raises(RuntimeError, match="CUDA"):
        quickstart.make_simulation(policy="all", mode="sync")


def test_unported_engine_options_raise(synmnist, synmnist_test, tmp_path):
    """Every engine option is ported now (`faults=`: test_torch_faults.py;
    `ckpt=` / `resume=`: test_torch_resume.py); what still raises is a
    resume from a checkpoint the run cannot take: an async run's state
    resumed by a sync run, as the reference refuses it."""
    _, tsim = _sims(synmnist, synmnist_test, policy="all", mode="async",
                    epochs=1)
    tsim.ckpt = CheckpointManager(tmp_path)
    tsim.run_async(max_merges=2)
    _, fresh = _sims(synmnist, synmnist_test, policy="all", mode="sync",
                     epochs=1)
    fresh.ckpt = tsim.ckpt
    with pytest.raises(ValueError, match="'async' run, not 'sync'"):
        fresh.run_sync(rounds=3, resume=True)


if __name__ == "__main__":
    # The JAX side of chip_smoke.py's accuracy check: the JAX quickstart's
    # best accuracy after 80 async merges, per seed (default 0-7); then the
    # same JAX run started from the port's initial params for that seed,
    # which differ from JAX's by a few ulp, to show how far rounding alone
    # moves one seed's result.
    import sys
    tm = build_model(get_config(ARCH))
    for seed in map(int, sys.argv[1:] or range(8)):
        best = jax_quickstart(seed).run_async(max_merges=80).best_acc
        port_init = {k: jnp.asarray(v.numpy()) for k, v in
                     tm.init(threefry.key(seed), device="cpu").items()}
        nudged = jax_quickstart(seed, port_init).run_async(
            max_merges=80).best_acc
        print(f"seed {seed}: best accuracy {best:.4f} "
              f"(from the port's initial params {nudged:.4f})", flush=True)

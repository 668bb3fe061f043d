"""Crash-safe resume on the port (`FLSimulation(ckpt=...)`, `resume=`),
held as tests/test_resume.py holds the reference -- killed + resumed ==
uninterrupted, record for record -- and against the JAX resumed stream."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.core.faults import FaultConfig as JaxFaultConfig
from repro_torch.checkpoint import CheckpointManager
from repro_torch.examples import resume
from test_resume import FAULTS as JAX_FAULTS
from test_resume import sim_with as jax_sim_with

MODES = ["sync", "async"]


@pytest.mark.parametrize("mode", MODES)
def test_events_resume_is_bit_identical(tmp_path, mode):
    """Byzantine corruption, drops and re-deliveries throughout, so the
    restored state covers both random streams, the policy, quarantine
    counters and (async) the in-flight heap; final params bit-equal."""
    ref, killed, resumed, _ = resume.crash_and_resume(mode, tmp_path, "cpu")
    assert killed.crashed and len(killed.records) < len(ref.records)
    assert not resumed.crashed
    assert killed.records + resumed.records == ref.records
    assert resume.holds(ref, killed, resumed)


@pytest.mark.parametrize("mode", MODES)
def test_resumed_stream_matches_jax(synmnist, synmnist_test, tmp_path, mode):
    """The port's resumed run against the reference's on the same fleet,
    faults and crash: time / round / n_selected / version exact, accuracy
    within 0.01 (the initial params differ by a few ulp)."""
    crash = resume.CRASH_AT[mode]
    jcrash = dataclasses.replace(JAX_FAULTS, server_crash_rounds=(crash,))
    run = (lambda s, **kw: s.run_sync(resume.RUN_LEN[mode], **kw)) \
        if mode == "sync" else \
        (lambda s, **kw: s.run_async(resume.RUN_LEN[mode], **kw))
    jmgr = JaxCheckpointManager(str(tmp_path / "jax"))
    run(jax_sim_with(synmnist, synmnist_test, mode=mode, faults=jcrash,
                     ckpt=jmgr))
    jres = run(jax_sim_with(synmnist, synmnist_test, mode=mode,
                            faults=jcrash, ckpt=jmgr), resume=True)
    tres = resume.crash_and_resume(mode, tmp_path / "port", "cpu")[2]
    assert len(tres.records) == len(jres.records) > 1
    cols = lambda res: [(r.time, r.round, r.n_selected, r.version)
                        for r in res.records]
    assert cols(tres) == cols(jres)
    np.testing.assert_allclose([r.acc for r in tres.records],
                               [r.acc for r in jres.records], atol=0.01)


@pytest.mark.parametrize("mode", MODES)
def test_resume_without_checkpoint_starts_fresh(tmp_path, mode):
    """resume=True with an empty checkpoint dir is a plain cold start, in
    async too (the reference's async engine skips its first dispatch
    there and idles a tick first)."""
    mgr = CheckpointManager(tmp_path / "empty")
    ref = resume.run(resume.make_sim(mode, device="cpu"), mode)
    res = resume.run(resume.make_sim(mode, ckpt=mgr, device="cpu"), mode,
                     resume=True)
    assert res.records == ref.records


def test_resume_refuses_the_other_mode(tmp_path):
    """A sync run's checkpoint is not an async run's state."""
    mgr = CheckpointManager(tmp_path)
    resume.make_sim("sync", ckpt=mgr, device="cpu").run_sync(1)
    with pytest.raises(ValueError, match="'sync' run, not 'async'"):
        resume.make_sim("async", ckpt=mgr, device="cpu").run_async(
            2, resume=True)


def test_fault_configs_are_the_references():
    assert dataclasses.asdict(resume.FAULTS) == \
        dataclasses.asdict(JAX_FAULTS)
    assert isinstance(JAX_FAULTS, JaxFaultConfig)


def test_resume_restores_server_optimizer_moments(tmp_path):
    """A FedAdam server (beyond_fedopt's): its momentum and variance trees
    ride in the checkpoint, so the resumed sync run still equals the
    uninterrupted one."""
    from repro_torch.core.server_opt import ServerOptimizer

    def adam_sim(faults, ckpt=None):
        sim = resume.make_sim("sync", faults=faults, ckpt=ckpt, device="cpu")
        sim.server._sopt = ServerOptimizer("adam", lr=0.03)
        sim.server._sopt_state = sim.server._sopt.init(sim.server.params)
        return sim
    crashing = dataclasses.replace(resume.FAULTS, server_crash_rounds=(3,))
    ref = adam_sim(resume.FAULTS).run_sync(5)
    mgr = CheckpointManager(tmp_path)
    killed = adam_sim(crashing, mgr).run_sync(5)
    fresh = adam_sim(crashing, mgr)
    resumed = fresh.run_sync(5, resume=True)
    assert fresh.server._sopt_state.variance is not None
    assert resume.holds(ref, killed, resumed)

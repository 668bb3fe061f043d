"""A run of the training cell's harness on the CPU at a size a test can
hold, past the look for a card: sound, it comes out correct; with its
timed path broken underneath (a fault planted in the program) or with
the float8 control in the program's place, it comes out not correct.

The limits here are this size's, set as the cell's are between the
readings of sound runs at this size and the control's: seeds 11-13,
sound loss under 3e-4, gradient under 1.1e-3, change under 1.5e-2,
float8 loss 1.3e-3 and more, gradient 5.9e-3 and more.  The fog cell's (two hops after
every step; with `overlap`, merged one step stale) at this size: seeds 11-13, sound loss
under 3.6e-4, gradient under 1.1e-3, change under 1.2e-2; float8 loss
2.5e-3 and more; half batch loss 0.025 and more; both hops left out
change 0.17 and more."""
import time

import pytest
import torch

from portbench import calibrate, core, judge
from portbench import run as prun

TRAIN_LIMITS = {"loss": 7e-4, "grad": 3e-3, "change": 4e-2}
SEED = 2**31 + 17


@pytest.fixture(scope="module")
def manifest():
    prun._environment()
    return core.load_manifest()


def _train_cell(manifest, traffic="fl-q8"):
    cfg = core.config_of(manifest, "qwen1.5-4b-fl8")
    cfg["as_run"].update(num_layers=2, d_model=64, num_heads=4,
                         num_kv_heads=4, head_dim=16, d_ff=128,
                         vocab_size=512)
    tr = core.traffic_of(traffic) | {"batch": 4, "seq": 16}
    return cfg, tr


def _execute(manifest, wname, cell, limits, seconds):
    cfg, tr = cell
    return prun.execute(manifest, wname, seed=SEED, seconds=seconds,
                        trace=False, device="cpu", t0=time.perf_counter(),
                        config=cfg, traffic=tr, limits=limits)


# -- faults planted in the program -----------------------------------------

def _state_unchanged(train):
    real_factory = train.make_fl_train_step

    def factory(*a, **kw):
        real = real_factory(*a, **kw)

        def step(params, opt_state, batch):
            _, _, metrics = real(_tree_map(torch.clone, params),
                                 _tree_map(torch.clone, opt_state), batch)
            return params, opt_state, metrics
        return step
    return {"make_fl_train_step": factory}


def _half_batch(train):
    real_factory = train.make_fl_train_step

    def factory(*a, **kw):
        real = real_factory(*a, **kw)

        def step(params, opt_state, batch):
            half = {k: v[:, :v.shape[1] // 2] for k, v in batch.items()}
            return real(params, opt_state, half)
        return step
    return {"make_fl_train_step": factory}


def _no_exchange(train):
    def factory(*a, **kw):
        def agg(stacked, *rest):
            return stacked
        return agg
    return {"make_fl_aggregate": factory}


def _no_fog_exchange(hierarchy):
    """Both hops left out: every island keeps its own weights (copies, as
    an exchange's result is)."""
    def agg(stacked, *a, **kw):
        return _tree_map(torch.clone, stacked)
    return {"hierarchical_sync_aggregate": agg}


def _loss_altered(train):
    real_factory = train.make_fl_train_step

    def factory(*a, **kw):
        real = real_factory(*a, **kw)

        def step(params, opt_state, batch):
            params, opt_state, metrics = real(params, opt_state, batch)
            return params, opt_state, metrics | {"loss": metrics["loss"]
                                                 * 1.01}
        return step
    return {"make_fl_train_step": factory}


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def test_train_cell_is_correct_when_sound(manifest):
    out = _execute(manifest, "qwen4b-fl-q8", _train_cell(manifest),
                   TRAIN_LIMITS, 0.3)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["metrics"]["train_tokens_per_s"]["value"] > 0
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _no_exchange, _loss_altered],
                         ids=["state_unchanged", "half_batch", "no_exchange",
                              "loss_altered"])
def test_train_cell_fails_a_planted_fault(manifest, fault):
    from repro_torch.launch import train
    with core.patched(train, **fault(train)):
        out = _execute(manifest, "qwen4b-fl-q8", _train_cell(manifest),
                       TRAIN_LIMITS, 0.3)
    assert not out["correct"], out["checks"]


def test_train_control_fails(manifest):
    cfg, tr = _train_cell(manifest)
    got = calibrate.readings(manifest, "qwen4b-fl-q8", [SEED],
                             program=False, variants=["fp8"], seconds=0.3,
                             device="cpu", config=cfg, traffic=tr)
    ok, checks = judge.decide(got[0]["numbers"], TRAIN_LIMITS)
    assert got[0]["who"] == "fp8" and not ok, checks


# -- the fog cell: two hops after every step -------------------------------

FOG = "qwen4b-fl-fog-e1-sync"


def test_fog_cell_is_correct_when_sound(manifest):
    out = _execute(manifest, FOG, _train_cell(manifest, "fl-fog-e1-sync"),
                   TRAIN_LIMITS, 0.3)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _no_fog_exchange, _loss_altered],
                         ids=["state_unchanged", "half_batch", "no_exchange",
                              "loss_altered"])
def test_fog_cell_fails_a_planted_fault(manifest, fault):
    from repro_torch.core import hierarchy
    from repro_torch.launch import train
    module = hierarchy if fault is _no_fog_exchange else train
    with core.patched(module, **fault(module)):
        out = _execute(manifest, FOG, _train_cell(manifest, "fl-fog-e1-sync"),
                       TRAIN_LIMITS, 0.3)
    assert not out["correct"], out["checks"]


def test_fog_control_fails(manifest):
    cfg, tr = _train_cell(manifest, "fl-fog-e1-sync")
    got = calibrate.readings(manifest, FOG, [SEED], program=False,
                             variants=["fp8"], seconds=0.3, device="cpu",
                             config=cfg, traffic=tr)
    ok, checks = judge.decide(got[0]["numbers"], TRAIN_LIMITS)
    assert got[0]["who"] == "fp8" and not ok, checks


def test_fog_cell_with_overlap_is_correct_when_sound(manifest):
    """The exchange merged one step stale (`--overlap`), which the full
    cell cannot hold in 80 GB: the reference follows the program."""
    cfg, tr = _train_cell(manifest, "fl-fog-e1-sync")
    out = _execute(manifest, FOG, (cfg, tr | {"overlap": True}),
                   TRAIN_LIMITS, 0.3)
    assert out["correct"], out["checks"]


def test_fog_cell_with_overlap_fails_without_the_exchange(manifest):
    from repro_torch.core import hierarchy
    cfg, tr = _train_cell(manifest, "fl-fog-e1-sync")
    with core.patched(hierarchy, **_no_fog_exchange(hierarchy)):
        out = _execute(manifest, FOG, (cfg, tr | {"overlap": True}),
                       TRAIN_LIMITS, 0.3)
    assert not out["correct"], out["checks"]

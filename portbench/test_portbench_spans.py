"""The readers of the program's spans: medians over complete steps only,
launches and synchronisations counted inside complete step ranges only,
nothing where the program recorded nothing, and the seven metrics in the
line of a traced run of each training cell on the CPU."""
import itertools
import math
import time

import pytest

from portbench import core
from portbench import run as prun
from portbench.test_portbench_faults import SEED, TRAIN_LIMITS, _train_cell
from portbench.trace import WINDOW, Trace
from repro_torch import spans

SPAN_METRICS = ("forward_ms.train", "backward_ms.train", "optimizer_ms.train",
                "delta_ms.exchange", "mix_ms.exchange")
TRACE_METRICS = ("launches_per_step.train", "syncs_per_step.train")


def _run(trace=None, islands=2):
    return core.Run("w", {}, {"islands": islands}, 0, 1.0, True, "cpu",
                    core.Record(trace=trace))


def _sp(i, name, ms, **attrs):
    return spans.Span(i, None, name, attrs, ms)


@pytest.fixture
def recorded(monkeypatch):
    ids = iter(range(1, 1000))
    out = []
    # step 4: island 1's optimizer missing (the profiler stopped); step 5
    # and 6 whole, island 0 with two microbatches in step 6; step 7 only
    # island 0
    for step, isl, f, b, o in [(4, 0, 9, 90, 900), (4, 1, 9, 90, None),
                               (5, 0, 1, 10, 100), (5, 1, 2, 20, 200),
                               (6, 0, 3, 30, 300), (6, 1, 4, 40, 400),
                               (7, 0, 5, 50, 500)]:
        out.append(_sp(next(ids), "step.forward", f, step=step, island=isl))
        out.append(_sp(next(ids), "step.backward", b, step=step, island=isl))
        if o is not None:
            out.append(_sp(next(ids), "step.optimizer", o, step=step,
                           island=isl))
    out.append(_sp(next(ids), "step.forward", 0.5, step=6, island=0))
    out.append(_sp(next(ids), "step.backward", 5.0, step=6, island=0))
    out += [_sp(next(ids), "exchange.delta", 7.0, step=6, round=3),
            _sp(next(ids), "exchange.delta", 9.0, step=8, round=4),
            _sp(next(ids), "exchange.mix", 11.0, step=6, round=3),
            _sp(next(ids), "train.step", 1e4, step=6, round=3)]
    monkeypatch.setattr(spans, "spans", lambda: list(out))
    return out


def test_phases_are_medians_over_complete_steps(recorded):
    read = core.metric_reader
    run = _run()
    # steps 5 and 6 only: (1 + 2, 3 + 0.5 + 4) -> median 5.25
    assert math.isclose(read("forward_ms.train")(run), (3 + 7.5) / 2)
    assert math.isclose(read("backward_ms.train")(run), (30 + 75) / 2)
    assert math.isclose(read("optimizer_ms.train")(run), (300 + 700) / 2)
    assert math.isclose(read("delta_ms.exchange")(run), 8.0)
    assert math.isclose(read("mix_ms.exchange")(run), 11.0)
    # with three islands no step is whole
    assert read("forward_ms.train")(_run(islands=3)) is None


def test_launches_and_syncs_count_inside_complete_step_ranges():
    host = [(WINDOW, 0.0, 1000.0),
            # a complete step: 3 launches (one `cudaLaunchKernel` with
            # the `cuLaunchKernel` it made inside it), 2 synchronisations
            ("repro.train.step", 100.0, 300.0),
            ("cudaLaunchKernel", 110.0, 10.0), ("cuLaunchKernel", 112.0, 5.0),
            ("cudaLaunchKernel", 150.0, 5.0), ("cuLaunchKernelEx", 160.0, 5.0),
            ("cudaDeviceSynchronize", 200.0, 50.0),
            ("cudaStreamSynchronize", 260.0, 5.0),
            ("cudaMemcpyAsync", 270.0, 5.0),
            # another complete step: 1 launch, 0 synchronisations
            ("repro.train.step", 450.0, 100.0),
            ("cudaLaunchKernel", 460.0, 5.0),
            # a launch between steps, and a step cut by the window's end
            ("cudaLaunchKernel", 420.0, 5.0),
            ("repro.train.step", 900.0, 300.0),
            ("cudaLaunchKernel", 910.0, 5.0),
            ("cudaDeviceSynchronize", 920.0, 5.0)]
    run = _run(Trace(device=[], host=host, t0=0.0, t1=1000.0))
    assert core.metric_reader("launches_per_step.train")(run) == 2.0
    assert core.metric_reader("syncs_per_step.train")(run) == 1.0


@pytest.mark.parametrize("name", SPAN_METRICS + TRACE_METRICS)
def test_nothing_to_read_gives_nothing(name, monkeypatch):
    monkeypatch.setattr(spans, "spans", lambda: [])
    host = [(WINDOW, 0.0, 10.0), ("cudaLaunchKernel", 1.0, 1.0)]
    for run in (_run(), _run(Trace([], host, 0.0, 10.0))):
        assert core.metric_reader(name)(run) is None


def _traced_cell(monkeypatch, wname, traffic, seconds):
    manifest = core.load_manifest()
    prun._environment()
    spans.reset()
    ticks = itertools.count()
    monkeypatch.setattr(core, "now", lambda: 0.1 * next(ticks))
    cfg, tr = _train_cell(manifest, traffic)
    out = prun.execute(manifest, wname, seed=SEED, seconds=seconds,
                       trace=True, device="cpu", t0=time.perf_counter(),
                       config=cfg, traffic=tr, limits=TRAIN_LIMITS)
    spans.reset()
    m = out["metrics"]
    assert out["correct"]
    for name in SPAN_METRICS:
        assert m[name]["value"] > 0, name
    for name in TRACE_METRICS:
        assert m[name]["value"] == 0, name
    return m


def test_a_traced_run_reports_the_seven_metrics(monkeypatch):
    """The training cell at a test's size on the CPU, traced: the span
    metrics read the profiled round, the counts its step range (no kernel
    launch on the CPU).  The harness's clock ticks 0.1 s a reading, so the
    window opens, profiles a round and closes at the same steps however
    fast the host runs."""
    _traced_cell(monkeypatch, "qwen4b-fl-q8", "fl-q8", 1.0)


def test_a_traced_fog_run_reports_the_seven_metrics(monkeypatch):
    """The same of the fog cell, whose rounds are of one step: the traced
    rounds are the two that hold two steps, so one step range is whole,
    and the window is longer, to close after them.  Its exchange span
    wraps both hops."""
    m = _traced_cell(monkeypatch, "qwen4b-fl-fog-e1-sync",
                     "fl-fog-e1-sync", 2.0)
    assert m["exchange_ms"]["value"] > 0

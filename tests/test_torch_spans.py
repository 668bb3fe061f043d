"""The port's spans (`repro_torch.spans`): nothing recorded and no
profiler range entered while tracing is off; under `torch.profiler` the
federated train loop leaves its `repro.*` ranges nested as the recorder's
parent ids say; `--trace` prints one line a round."""
import json

import pytest
import torch

from repro_torch import spans
from repro_torch.configs import get_smoke_config
from repro_torch.launch import train

ARGV = ["--device", "cpu", "--smoke", "--islands", "2", "--local-steps", "2",
        "--compress", "q8", "--steps", "4", "--batch", "2", "--seq", "16"]
PHASES = ("step.forward", "step.backward", "step.optimizer")
EXCHANGE = ("exchange.delta", "exchange.quantise", "exchange.dequantise",
            "exchange.mix", "train.base_copy")


@pytest.fixture(autouse=True)
def clean_recorder():
    spans.reset()
    yield
    spans.disable()
    spans.set_context()
    spans.reset()


@pytest.fixture
def entered(monkeypatch):
    """The names of the profiler ranges spans enter."""
    names = []
    real = torch.profiler.record_function

    def spy(name, *a, **kw):
        names.append(name)
        return real(name, *a, **kw)
    monkeypatch.setattr(torch.profiler, "record_function", spy)
    return names


def test_off_records_nothing_and_enters_no_range(entered):
    ctx = spans.span("train.step", island=0)
    assert ctx is spans.span("step.forward")      # one shared no-op
    with ctx:
        with spans.span("step.backward"):
            torch.ones(4).sum()
    assert spans.spans() == [] and entered == []


def test_a_span_opened_off_stays_a_no_op(entered):
    with spans.span("train.step"):
        spans.enable()
        with spans.span("step.forward", island=1):
            pass
    spans.disable()
    [sp] = spans.spans()
    assert (sp.name, sp.parent, sp.attrs) == ("step.forward", None,
                                              {"island": 1})
    assert entered == ["repro.step.forward"]


def test_on_records_ids_parents_attrs_and_stream_times(entered):
    spans.enable()
    spans.set_context(step=3, round=2)
    with spans.span("train.step") as outer:
        with spans.span("step.forward", island=1) as inner:
            torch.ones(64, 64) @ torch.ones(64, 64)
    spans.set_context()
    with spans.span("train.exchange") as ex:
        pass
    got = spans.spans()
    assert [s.name for s in got] == ["step.forward", "train.step",
                                     "train.exchange"]
    assert inner.parent == outer.id and outer.parent is None
    assert ex.parent is None and ex.attrs == {}
    assert inner.attrs == {"step": 3, "round": 2, "island": 1}
    assert outer.attrs == {"step": 3, "round": 2}
    assert all(s.ms >= 0 for s in got) and outer.ms >= inner.ms
    assert entered == ["repro.train.step", "repro.step.forward",
                       "repro.train.exchange"]
    spans.reset()
    assert spans.spans() == []


def _ranges(events):
    return [(e["name"][len("repro."):], e["ts"], e["ts"] + e["dur"])
            for e in events if e.get("ph") == "X"
            and e.get("cat") == "user_annotation"
            and e["name"].startswith("repro.")]


def _inside(ranges, outer, name):
    _, a, b = outer
    return [r for r in ranges if r[0] == name and a <= r[1] and r[2] <= b]


def test_train_loop_spans_nest_in_the_profilers_trace(tmp_path):
    P, accum = 2, max(1, get_smoke_config("granite-20b").grad_accum)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        train.main(ARGV)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    ranges = _ranges(json.loads(path.read_text())["traceEvents"])

    steps = [r for r in ranges if r[0] == "train.step"]
    exchanges = [r for r in ranges if r[0] == "train.exchange"]
    assert len(steps) == 4 and len(exchanges) == 2
    for st in steps:
        assert len(_inside(ranges, st, "train.batch")) == 1
        for name in ("step.forward", "step.backward"):
            assert len(_inside(ranges, st, name)) == P * accum
        assert len(_inside(ranges, st, "step.optimizer")) == P
    for ex in exchanges:
        for name in EXCHANGE:
            assert len(_inside(ranges, ex, name)) == 1, name
    n_outside = sum(1 for r in ranges if r[0] in PHASES + EXCHANGE) - sum(
        len(_inside(ranges, o, n)) for o in steps + exchanges
        for n in PHASES + EXCHANGE)
    assert n_outside == 0

    rec = spans.spans()
    by_id = {s.id: s for s in rec}
    parent_of = {s.name: set() for s in rec}
    for s in rec:
        parent_of[s.name].add(by_id[s.parent].name if s.parent else None)
    assert parent_of == {
        "train.step": {None}, "train.exchange": {None},
        "train.batch": {"train.step"},
        **{n: {"train.step"} for n in PHASES},
        **{n: {"train.exchange"} for n in EXCHANGE}}
    for s in rec:
        parent = by_id.get(s.parent)
        assert s.attrs["step"] in (1, 2, 3, 4)
        assert s.attrs["round"] == (s.attrs["step"] + 1) // 2
        if parent is not None:
            assert parent.attrs["step"] == s.attrs["step"]
    islands = {}
    for s in rec:
        if s.name in PHASES:
            islands.setdefault(s.attrs["step"], set()).add(
                s.attrs["island"])
    assert islands == {k: {0, 1} for k in (1, 2, 3, 4)}
    assert all("island" not in s.attrs for s in rec if s.name not in PHASES)


def test_trace_flag_prints_one_line_a_round(capsys):
    out = train.main(ARGV + ["--trace"])
    lines = [l for l in capsys.readouterr().out.splitlines()
             if l.startswith("[trace]")]
    assert [l.split()[1] for l in lines] == ["round=1", "round=2"]
    for line in lines:
        names = [kv.split("=")[0] for kv in line.split()[2:]]
        assert names == list(train.TRACE_LINE)
        assert all(kv.endswith("ms") for kv in line.split()[2:])
    assert spans.spans() == []          # each line resets the recorder
    assert len(out["step_ms"]) == 4


def test_without_trace_no_line_and_nothing_recorded(capsys):
    train.main(ARGV)
    assert "[trace]" not in capsys.readouterr().out
    assert spans.spans() == []

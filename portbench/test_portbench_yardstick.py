"""The yardstick on the CPU: generators, metric arithmetic, rooflines and
the imports the harness may make."""
import ast
import math

import numpy as np
import pytest

from portbench import core, gen, judge, roofline
from portbench.trace import Trace, union


# -- generators ------------------------------------------------------------

def test_token_stream_same_for_the_same_seed():
    a = gen.token_stream(151936, 10_000, 2**31 + 11, island=1)
    b = gen.token_stream(151936, 10_000, 2**31 + 11, island=1)
    c = gen.token_stream(151936, 10_000, 2**31 + 11, island=0)
    assert a.dtype == np.int32 and np.array_equal(a, b)
    assert not np.array_equal(a, c)
    assert a.min() >= 0 and a.max() < 151936


def test_lm_rows_follow_the_train_loops_feed_rule():
    s = np.arange(1000, dtype=np.int32)
    x, y = gen.lm_rows(s, 2, 4, 1)
    assert x.tolist() == [[10, 11, 12, 13], [14, 15, 16, 17]]
    assert np.array_equal(y, x + 1)


# -- metric arithmetic -----------------------------------------------------

def test_idle_is_one_minus_the_union_of_device_intervals():
    tr = Trace(device=[("a", 0.0, 40.0), ("b", 20.0, 40.0),
                       ("c", 70.0, 10.0), ("d", 95.0, 20.0)],
               host=[("host_op", 55.0, 10.0), ("outer", 0.0, 100.0)],
               t0=0.0, t1=100.0)
    assert union([(0, 40), (20, 60), (70, 80)]) == [(0, 60), (70, 80)]
    assert math.isclose(tr.busy_s(), 75e-6)      # 0-60, 70-80, 95-100
    assert math.isclose(tr.window_s, 100e-6)
    gaps = dict(tr.idle_gaps())
    assert math.isclose(gaps["host_op"], 10e-6)    # 60-70, mid 65
    assert math.isclose(gaps["outer"], 15e-6)      # 80-95
    [(name, secs)] = tr.top_ops(1)
    assert name == "a" and math.isclose(secs, 40e-6)


def test_rate_and_mfu_take_the_whole_window():
    rec = core.Record()
    for i, d in enumerate([0.5, 0.7, 0.6]):
        rec.add("step", i, i + d, in_window=True)
    rec.add("step", -5, -1, in_window=False)       # set-up: not counted
    rec.facts.update(train_flops_per_token=1e9, tokens_per_step=1000)
    run = core.Run("w", {}, {}, 0, 1.0, True, "cpu", rec)
    got = core.metric_reader("mfu.train")(run)
    assert math.isclose(got, 100 * 3 * 1e12 / (1.8 * roofline.BF16_FLOPS))
    assert math.isclose(core.metric_reader("step_ms")(run), 600.0)


def test_readers_return_nothing_without_something_to_read():
    run = core.Run("w", {}, {}, 0, 1.0, True, "cpu", core.Record())
    for name in ("exchange_ms", "step_ms", "mfu.train", "quant8_roofline",
                 "idle_pct.train", "peak_gb.train"):
        assert core.metric_reader(name)(run) is None, name


# -- rooflines against hand counts -----------------------------------------

def test_quant8_bytes_of_the_exchange():
    # 5,253,144 fp32 elements in 2,052 rows: quantise reads 4 B and
    # writes 1 B an element and 4 B a row's scale; dequantise the reverse
    q, dq = roofline.quant8_bytes(5_253_144, 2_052)
    assert q == dq == 5_253_144 * 5 + 2_052 * 4 == 26_273_928


def test_train_flops():
    assert roofline.train_flops_per_token(10, 2, 3, 4) == 60 + 12 * 24


# -- the numbers that decide correct ---------------------------------------

def test_leaf_gaps_and_the_gradient_floor():
    ref = {"loss": [[2.0, 2.0]],
           "grad": {"a": [1.0, 1.0], "b": [2.0, 2.0], "bias": [1e-6, 1e-6]},
           "change": {"a": [1.0, 1.0], "b": [1.0, 1.0], "bias": [5.0, 5.0]}}
    prog = {"loss": [[2.002, 2.0]],
            "grad": {"a": [1.01, 1.0], "b": [2.0, 2.0], "bias": [0, 0]},
            "change": {"a": [1.0, 1.0], "b": [1.02, 1.0], "bias": [0, 0]}}
    n = judge.train_numbers(prog, ref)
    assert math.isclose(n["loss"], 1e-3)
    assert math.isclose(n["grad"], 0.01)      # a's gap over the median, 1.0
    assert math.isclose(n["change"], 0.02)    # bias is left out
    ok, checks = judge.decide(n, {"loss": 2e-3, "grad": 0.02,
                                  "change": 0.01})
    assert not ok and checks["change"] == {"value": n["change"],
                                           "limit": 0.01}
    assert not judge.decide({"x": float("nan")}, {"x": 1.0})[0]


# -- imports -----------------------------------------------------------------

def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr",
                                                    "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield node.args[0].value


@pytest.mark.parametrize("path", sorted(core.BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(core.BENCH)))
def test_no_module_of_jax_or_of_the_jax_package(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in core.FORBIDDEN]
    assert not bad


@pytest.mark.parametrize("path", sorted((core.BENCH / "reference")
                                        .glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert not [m for m in _imports(path)
                if m.split(".")[0] == "repro_torch"]


def test_forbidden_modules_compare_whole_top_level_names():
    assert core.forbidden_modules(["repro_torch", "repro_torch.models",
                                   "jaxtyping", "numpy"]) == []
    assert core.forbidden_modules(["repro", "repro.models", "jax.numpy",
                                   "flax"]) == ["flax", "jax.numpy",
                                                "repro", "repro.models"]

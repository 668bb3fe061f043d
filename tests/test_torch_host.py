"""The PyTorch port's copies of the framework-free host modules must equal
the JAX package's originals exactly, and the port must import neither jax
nor the JAX package."""
import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config
from repro.core import cost_model as jcm
from repro.core import selection as jsel
from repro.data import partition as jpart
from repro.data import synthetic as jsyn
from repro.models import config as jconfig
from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.core import cost_model as tcm
from repro_torch.core import selection as tsel
from repro_torch.data import partition as tpart
from repro_torch.data import synthetic as tsyn
from repro_torch.models import config as tconfig

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("kind,n,seed", [("synmnist", 300, 0),
                                         ("synmnist", 257, 5),
                                         ("syncifar", 64, 1)])
def test_classification_set_bit_equal(kind, n, seed):
    xj, yj = jsyn.make_classification_set(kind, n, seed=seed)
    xt, yt = tsyn.make_classification_set(kind, n, seed=seed)
    assert xj.dtype == xt.dtype and yj.dtype == yt.dtype
    assert np.array_equal(xj, xt) and np.array_equal(yj, yt)


def test_token_stream_bit_equal():
    assert np.array_equal(jsyn.make_token_stream(97, 500, seed=3),
                          tsyn.make_token_stream(97, 500, seed=3))


def test_partitions_bit_equal():
    x, y = jsyn.make_classification_set("synmnist", 640, seed=2)
    for batches, seed in (([4, 2, 2, 1, 1], 0), ([1, 0, 3], 7)):
        js = jpart.partition_by_batches(x, y, batches, batch_size=64,
                                        seed=seed)
        ts = tpart.partition_by_batches(x, y, batches, batch_size=64,
                                        seed=seed)
        for (a, b), (c, d) in zip(js, ts):
            assert np.array_equal(a, c) and np.array_equal(b, d)
    js = jpart.dirichlet_partition(x, y, 4, alpha=0.5, seed=1)
    ts = tpart.dirichlet_partition(x, y, 4, alpha=0.5, seed=1)
    for (a, b), (c, d) in zip(js, ts):
        assert np.array_equal(a, c) and np.array_equal(b, d)
    for cfg in range(1, 7):
        assert jpart.paper_table3(cfg) == tpart.paper_table3(cfg)
        assert jpart.paper_table4(cfg) == tpart.paper_table4(cfg)


@pytest.mark.parametrize("name", ["flight-cnn-mnist", "flight-cnn-cifar"])
def test_configs_equal(name):
    assert name in list_archs()
    assert dataclasses.asdict(get_config(name)) == \
        dataclasses.asdict(jax_get_config(name))
    assert dataclasses.asdict(get_smoke_config(name)) == \
        dataclasses.asdict(jax_get_config(name))
    assert {k: dataclasses.asdict(v) for k, v in tconfig.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jconfig.SHAPES.items()}


def test_unported_arch_is_unknown():
    """Every arch of the reference is registered; an unknown name still
    raises KeyError."""
    with pytest.raises(KeyError):
        get_config("phi-4-vision-no-such-arch")


def _fleets(n_workers=8, seed=4):
    n_data = [64 * (i % 3) for i in range(n_workers)]
    jp = jcm.heterogeneous_profiles(n_workers, n_data, seed=seed)
    tp = tcm.heterogeneous_profiles(n_workers, n_data, seed=seed)
    kw = dict(t_onedata_server=5e-5, server_freq=2.4e9, model_bytes=82_000)
    return ({p.wid: jcm.make_stats(p, **kw) for p in jp},
            {p.wid: tcm.make_stats(p, **kw) for p in tp}, jp, tp)


def test_profiles_and_stats_equal():
    js, ts, jp, tp = _fleets()
    assert [dataclasses.asdict(p) for p in jp] == \
        [dataclasses.asdict(p) for p in tp]
    assert {w: dataclasses.asdict(s) for w, s in js.items()} == \
        {w: dataclasses.asdict(s) for w, s in ts.items()}
    for a, b in zip(jp, tp):
        assert a.true_t_one(2e-3) == b.true_t_one(2e-3)
        assert a.true_t_transmit(5000) == b.true_t_transmit(5000)
    js[0].observe(0.3, 0.1)
    ts[0].observe(0.3, 0.1)
    assert dataclasses.asdict(js[0]) == dataclasses.asdict(ts[0])


def test_alg1_alg2_trajectories_equal():
    """Alg. 1/2 selections and policy updates over a seeded sequence of
    accuracies (with EWMA observations in between) stay identical."""
    js, ts, _, _ = _fleets(10, seed=1)
    accs = np.random.default_rng(11).uniform(0.0, 1.0, size=25).cumsum() / 25
    jr, tr = jsel.RMinRMaxState(2.0, 4.0), tsel.RMinRMaxState(2.0, 4.0)
    jt = jsel.TimeBasedState(T=0.0, r=2, A=0.015)
    tt = tsel.TimeBasedState(T=0.0, r=2, A=0.015)
    obs = np.random.default_rng(12)
    for acc in accs:
        sel_j = jsel.rmin_rmax_select(js, jr)
        assert sel_j == tsel.rmin_rmax_select(ts, tr)
        budget = max(js[w].t_one * jr.rmax + js[w].t_transmit for w in sel_j)
        for w in sel_j:
            assert jsel.epochs_for_worker(js[w], jr, budget) == \
                tsel.epochs_for_worker(ts[w], tr, budget)
        sel_j = jsel.time_based_select(js, jt)
        assert sel_j == tsel.time_based_select(ts, tt)
        for w in sel_j:
            t1, tx = obs.uniform(0.01, 1.0, size=2)
            js[w].observe(t1, tx)
            ts[w].observe(t1, tx)
        jr, tr = jsel.rmin_rmax_update(jr, acc), tsel.rmin_rmax_update(tr, acc)
        jt = jsel.time_based_update(js, jt, acc)
        tt = tsel.time_based_update(ts, tt, acc)
        assert dataclasses.asdict(jr) == dataclasses.asdict(tr)
        assert dataclasses.asdict(jt) == dataclasses.asdict(tt)
    assert jt.T > 0


def test_baseline_selections_equal():
    js, ts, _, _ = _fleets(12, seed=2)
    assert jsel.select_all(js) == tsel.select_all(ts)
    assert jsel.select_fastest(js, 4, 2) == tsel.select_fastest(ts, 4, 2)
    rj, rt = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(5):
        assert jsel.select_random(js, 5, rj) == tsel.select_random(ts, 5, rt)
    util = {w: 1.0 + 0.1 * w for w in js}
    assert jsel.select_utility(js, 5, utilities=util,
                               rng=np.random.default_rng(3)) == \
        tsel.select_utility(ts, 5, utilities=util,
                            rng=np.random.default_rng(3))


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split("{")[0]


def test_port_imports_neither_jax_nor_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    bad = []
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            # `benchmarks` is the JAX harness, which imports `repro`
            if top in ("jax", "jaxlib", "repro", "flax", "optax",
                       "benchmarks"):
                bad.append(f"{f.relative_to(ROOT)}: {mod}")
    assert bad == []

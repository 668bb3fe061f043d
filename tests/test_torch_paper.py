"""The paper's experiment suite on the port (`repro_torch.examples.paper`)
against the JAX harness (`benchmarks/`): every figure's simulations at
reduced rounds and merges, seed 0, record for record (time, round,
n_selected and version exact, accuracy within 0.01), its CSV lines by name
and field count; run.py's `--seed`; overhead's rows."""
import collections
import contextlib
import importlib
import io
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:       # the JAX harness is the repo's
    sys.path.insert(0, str(ROOT))   # top-level `benchmarks` package

from benchmarks import common as jcommon
from benchmarks import fig18_async as jfig18
from benchmarks import overhead as joverhead
from benchmarks import run as jrun
from repro.core import events as jevents
from repro.models import build_model as jax_build_model
from repro_torch import threefry
from repro_torch.examples import paper_experiments
from repro_torch.examples.paper import common as tcommon
from repro_torch.examples.paper import overhead as toverhead
from repro_torch.examples.paper import run as trun
from repro_torch.kernels.fed_agg.kernel import fed_agg_grouped_cuda
from repro_torch.models import build_model
from repro_torch.tree import leaves

FIGURES = ["fig12", "fig13", "fig14", "fig15", "fig16", "fig17", "fig18",
           "fedopt"]
ROUNDS, MERGES = 4, 6   # alg. 2 first selects in round 3


@pytest.fixture(scope="module", autouse=True)
def shared_datasets():
    """One copy of each dataset for both harnesses: the port's generator
    is a copy of the reference's (held equal in test_torch_host.py)."""
    for n, seed in ((16384, 0), (1024, 99)):
        tcommon._DATA_CACHE[("synmnist", n, seed)] = jcommon.dataset(
            "synmnist", n, seed)


def _jax_main(fig: str):
    """The JAX harness's bench of that name (`benchmarks/run.py` builds its
    table inside its main); the port's modules carry the same names."""
    module = trun.BENCHES[fig].__module__.rsplit(".", 1)[1]
    return importlib.import_module(f"benchmarks.{module}").main


def _kwargs(fig: str) -> dict:
    kw = {"rounds": ROUNDS, "seed": 0}
    if fig == "fig18":
        kw["merges"] = MERGES
    return kw


def _shape(lines: list[str]) -> list[tuple[str, str, int]]:
    """(kind, name, field count) of each CSV line."""
    return [(f[0], f[1], len(f)) for f in (l.split(",") for l in lines)]


@pytest.mark.parametrize("fig", FIGURES)
def test_figure_matches_jax(fig):
    jout, tout = io.StringIO(), io.StringIO()
    with tcommon.recorded_results(jevents.FLSimulation) as jres, \
            contextlib.redirect_stdout(jout):
        _jax_main(fig)(**_kwargs(fig))
    before = fed_agg_grouped_cuda.launches
    with tcommon.recorded_results() as tres, \
            contextlib.redirect_stdout(tout):
        trun.BENCHES[fig](device="cpu", **_kwargs(fig))
    assert fed_agg_grouped_cuda.launches == before  # host: plain version
    assert len(tres) == len(jres) >= 1
    for j, t in zip(jres, tres):
        assert [(r.time, r.round, r.n_selected, r.version)
                for r in t.records] == \
            [(r.time, r.round, r.n_selected, r.version) for r in j.records]
        np.testing.assert_allclose([r.acc for r in t.records],
                                   [r.acc for r in j.records], atol=0.01)
    assert _shape(tout.getvalue().splitlines()) == \
        _shape(jout.getvalue().splitlines())


@pytest.mark.parametrize("table_config", [1, 2, 3])
def test_build_sim_matches_jax(table_config):
    """The fleet: initial params to a few ulp, shards, profiles, the
    server's estimates and model bytes."""
    kw = dict(table_config=table_config, policy="all", seed=0)
    jsim = jcommon.build_sim(**kw)
    tsim = tcommon.build_sim(device="cpu", **kw)
    for j, t in zip(jax.tree.leaves(jsim.server.params),
                    leaves(tsim.server.params)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                                   atol=1e-7)
    assert tsim.model_bytes == jsim.model_bytes
    assert sorted(tsim.workers) == sorted(jsim.workers)
    for w in jsim.workers:
        np.testing.assert_array_equal(tsim.workers[w].images,
                                      jsim.workers[w].images)
        assert tsim.workers[w].profile.__dict__ == \
            jsim.workers[w].profile.__dict__
        assert tsim.server.stats[w].__dict__ == jsim.server.stats[w].__dict__
    if table_config in (1, 3):  # Table III gives some workers no data
        assert min(w.images.shape[0] for w in tsim.workers.values()) == 0


def test_cnn_cifar_init_matches_jax():
    """The synCIFAR fleets' CNN (Table III configs 4-6) from one seed."""
    want = jax_build_model(jcommon.CNN_CIFAR).init(jax.random.key(3))
    got = build_model(tcommon.CNN_CIFAR).init(threefry.key(3), "cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7)


def test_run_passes_seed_and_device_to_every_bench(monkeypatch):
    """Unlike the JAX harness (`benchmarks/run.py` parses --seed and calls
    each bench without it), `--seed` reaches every main."""
    calls = {}
    for name in trun.BENCHES:
        monkeypatch.setitem(trun.BENCHES, name,
                            lambda name=name, **kw: calls.setdefault(name, kw))
    with contextlib.redirect_stdout(io.StringIO()) as out:
        res = trun.main(["--seed", "3", "--device", "cpu"])
    assert calls == {n: {"seed": 3, "device": "cpu"} for n in trun.BENCHES}
    assert list(res) == list(trun.BENCHES)
    assert sum(l.startswith("bench.") for l in
               out.getvalue().splitlines()) == len(trun.BENCHES)
    calls.clear()
    with contextlib.redirect_stdout(io.StringIO()):
        paper_experiments.main(["fig18,fig12", "--seed", "5",
                                "--device", "cpu"])
    assert calls == {n: {"seed": 5, "device": "cpu"}
                     for n in ("fig12", "fig18")}
    assert set(trun.BENCHES) == \
        {l.split('"')[1] for l in Path(jrun.__file__).read_text()
         .splitlines() if l.strip().startswith('"') and ".main" in l}
    monkeypatch.undo()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        res = trun.main(["--only", "roofline", "--device", "cpu"])
    assert out.getvalue().splitlines()[1] == "name,us_per_call,derived"
    assert isinstance(res["roofline"][0], list)
    with pytest.raises(ValueError, match="unknown bench"):
        trun.main(["--only", "fig99", "--device", "cpu"])


def test_overhead_rows_are_the_references():
    """Overhead's rows by name and field count on the CPU, where the
    kernel row names the plain version (the card's says `cuda`)."""
    jout, tout = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(jout):
        joverhead.main()
    with contextlib.redirect_stdout(tout):
        toverhead.main(device="cpu")
    jl, tl = jout.getvalue().splitlines(), tout.getvalue().splitlines()
    assert [(l.split(",")[0], l.count(",")) for l in tl] == \
        [(l.split(",")[0], l.count(",")) for l in jl]
    kernel_row = next(l for l in tl if l.startswith("kernel.fed_agg"))
    assert kernel_row.endswith(",plain")
    ratio = lambda ls: next(l for l in ls if l.startswith("compression"))
    assert ratio(tl).split(",")[2] == ratio(jl).split(",")[2]


def jax_fig18(seed: int, *, nudge: float = 0.0) -> dict:
    """The JAX harness's fig18 at `seed`, its CSV lines swallowed; with
    `nudge` = +-inf, every initial param moved one ulp that way
    (`np.nextafter`)."""
    build = jfig18.build_sim
    if nudge:
        def nudged(**kw):
            sim = jcommon.build_sim(**kw)
            sim.server.params = jax.tree.map(
                lambda p: jnp.nextafter(p, nudge), sim.server.params)
            return sim
        jfig18.build_sim = nudged
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            return jfig18.main(seed=seed)
    finally:
        jfig18.build_sim = build


def compare_suite_csv(path: str):
    """The JAX harness's figures at seed 0 beside a port run's CSV
    (`chip_smoke.py` writes artifacts/paper_suite_seed0.csv): per curve,
    its points, those whose printed time or selection count differ, and
    the largest accuracy gap; then the summary lines that differ."""
    jax_csv = io.StringIO()
    with contextlib.redirect_stdout(jax_csv):
        for fig in FIGURES:
            _jax_main(fig)(seed=0)
    curves = collections.defaultdict(lambda: ([], []))
    summaries = ([], [])
    for side, text in enumerate((jax_csv.getvalue(),
                                 Path(path).read_text())):
        for line in text.splitlines():
            f = line.split(",")
            if f[0] == "curve":
                curves[f[1]][side].append(f[2:])
            elif f[0] == "summary":
                summaries[side].append(line)
    for name, (j, t) in curves.items():
        moved = sum(a[0] != b[0] or a[2] != b[2] for a, b in zip(j, t))
        gap = max((abs(float(a[1]) - float(b[1])) for a, b in zip(j, t)),
                  default=0.0)
        print(f"{name}: {len(j)} points (port {len(t)}), {moved} differ in "
              f"time or selection, accuracy gap {gap:.4f}")
    for j, t in zip(*summaries):
        print(f"summary {'equal' if j == t else 'DIFFERS'}: JAX {j} | "
              f"port {t}")


if __name__ == "__main__":
    # The JAX side of chip_smoke.py's fig18 check: the JAX harness's
    # selection and async gains per seed (default 0-7) on the CPU, then the
    # same run from initial params one ulp up and one ulp down, to show how
    # far rounding alone moves them.  With --suite-csv <path>: the JAX
    # figures at seed 0 beside a port run's CSV.
    if sys.argv[1:2] == ["--suite-csv"]:
        compare_suite_csv(sys.argv[2])
        sys.exit(0)
    for seed in map(int, sys.argv[1:] or range(8)):
        runs = [jax_fig18(seed, nudge=n) for n in (0.0, np.inf, -np.inf)]
        print(f"seed {seed}: " + ", ".join(
            f"{label} selection_gain {r['selection_gain']:.6f} async_gain "
            f"{r['async_gain']:.6f}" for label, r in
            zip(("own", "one ulp up", "one ulp down"), runs)), flush=True)

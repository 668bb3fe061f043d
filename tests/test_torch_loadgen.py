"""The port's load generator (repro_torch/launch/loadgen.py), a copy of
the framework-free `repro.launch.loadgen`: `generate` gives the
reference's trace exactly (arrival times, prompts, output budgets) for
three seeds with and without shared prefixes, `summarize` the reference's
numbers on the same records, and a virtual-clock run through the port's
PagedServeLoop replays exactly (tests/test_loadgen.py's properties)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.launch import loadgen as jloadgen
from repro_torch import threefry
from repro_torch.configs import get_smoke_config
from repro_torch.launch import loadgen
from repro_torch.launch.serve_loop import PagedServeLoop
from repro_torch.models import build_model


def _cfg(mod, **kw):
    base = dict(qps=20.0, duration_s=1.0, seed=11, vocab_size=499,
                prompt_mean=12, prompt_max=40, out_mean=5, out_max=10,
                shared_prefix_frac=0.3, shared_prefix_len=8)
    base.update(kw)
    return mod.LoadConfig(**base)


def test_load_config_fields_and_defaults_match():
    assert dataclasses.asdict(loadgen.LoadConfig()) == \
        dataclasses.asdict(jloadgen.LoadConfig())


@pytest.mark.parametrize("shared", [0.0, 0.5])
@pytest.mark.parametrize("seed", [0, 7, 11])
def test_generate_equals_reference(seed, shared):
    kw = dict(seed=seed, shared_prefix_frac=shared, duration_s=3.0)
    got = loadgen.generate(_cfg(loadgen, **kw))
    want = jloadgen.generate(_cfg(jloadgen, **kw))
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert (a.rid, a.t, a.max_new) == (b.rid, b.t, b.max_new)
        assert a.prompt.dtype == b.prompt.dtype
        np.testing.assert_array_equal(a.prompt, b.prompt)


def test_summarize_equals_reference():
    rng = np.random.default_rng(3)
    recs = []
    for i in range(17):
        t0 = float(rng.random())
        t1 = t0 + float(rng.random())
        recs.append(dict(rid=i, t_arrive=t0, t_first=t1,
                         t_done=t1 + float(rng.random()),
                         n_prompt=int(rng.integers(4, 40)),
                         out=tuple(rng.integers(0, 99, int(rng.integers(
                             1, 9))).tolist())))
    got = loadgen.summarize([loadgen.ServedRecord(**r) for r in recs], 2.5)
    want = jloadgen.summarize([jloadgen.ServedRecord(**r) for r in recs],
                              2.5)
    assert got == want
    assert got["n_requests"] == 17


def test_virtual_clock_run_is_deterministic():
    """Two virtual-clock runs (fresh loops, same trace) produce identical
    records: timestamps, prompts and generated tokens."""
    model = build_model(get_smoke_config("granite-20b"))
    params = model.init(threefry.key(0), "cpu")
    trace = loadgen.generate(_cfg(loadgen, qps=30.0, duration_s=0.5))

    def run():
        loop = PagedServeLoop(model, params, max_batch=2, num_blocks=32,
                              block_size=8, chunk=16)
        return loadgen.run_trace(loop, trace, tick_s=0.01)

    r1, r2 = run(), run()
    assert r1 == r2
    assert all(rec.t_done >= rec.t_first >= rec.t_arrive >= 0 for rec in r1)

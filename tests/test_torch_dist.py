"""The port's planning layer (dist/sharding.py, dist/policy.py,
launch/mesh.py, launch/dryrun.py, serve.pick_layout, the loops' mesh= /
layout=, models/cache.py's axes and bytes) against the JAX package's, on
the CPU.  Host logic: specs, fallback records, warnings, decisions and
analytic bytes must be EQUAL at the reference's constants and meshes;
step times within 1e-12 relative (a float sum in another order).

  * the reference's sharding cases (tests/test_sharding_rules.py,
    test_dist_extra.py, test_policy.py's rule-set factory) and a seeded
    sweep of random meshes, logical axes and shapes: specs, records and
    warnings equal; placements over an AbstractMesh and a gloo DeviceMesh;
  * `decide`'s cases (tests/test_policy.py) and, for every arch's full
    config x serve shape x the reference's (16, 16) and (2, 16, 16)
    meshes at its 16 GB / 819 GB/s / 50 GB/s: the same decision and every
    candidate's bytes; `check_fit` line for line;
  * every arch's param, input and cache defs: shapes, itemsizes and
    logical axes equal for head / ring / replicated x bf16 / int8;
  * pick_layout forced and on auto, ServeLoop(mesh=) under a small budget
    (the same int8 spec, tokens under serve_load.divergence);
  * the dry run's CLI: --check-fit on the Hopper meshes, one full cell's
    artifact, rendered by examples/roofline.py and gen_experiments.py.
"""
import contextlib
import dataclasses
import functools
import io
import json
import os
import socket
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.dist import policy as jpolicy  # noqa: E402
from repro.dist import sharding as jsh  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.launch.serve_loop import Request as JaxRequest  # noqa: E402
from repro.launch.serve_loop import ServeLoop as JaxServeLoop  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import cache as jcache  # noqa: E402
from repro.models.config import SHAPES as JSHAPES  # noqa: E402
from repro.models.param import is_def as jax_is_def  # noqa: E402

from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.dist import hardware, policy
from repro_torch.dist import sharding as sh
from repro_torch.examples import gen_experiments, roofline, serve_load
from repro_torch.launch import dryrun, mesh as tmesh, serve
from repro_torch.launch.serve_loop import Request, ServeLoop
from repro_torch.models import build_model, cache as tcache
from repro_torch.models.config import SHAPES
from repro_torch.models.param import from_reference
from repro_torch.tree import leaves

ROOT = Path(__file__).resolve().parents[1]

#: the reference's hardware model (repro.dist.policy / hlo_analysis)
REF_HW = hardware.Hardware("reference constants",
                           {"bfloat16": 197e12, "float32": 197e12},
                           819e9, 16e9, 50e9, 50e9)
REF_MESHES = (((16, 16), ("data", "model")),
              ((2, 16, 16), ("pod", "data", "model")))
LMS = [a for a in list_archs() if get_config(a).family != "cnn"]


def _meshes(sizes, names):
    return jsh.abstract_mesh(sizes, names), sh.AbstractMesh(sizes, names)


def _spec(spec):
    return tuple(spec)


# ---------------------------------------------------------------------------
# Sharding
# ---------------------------------------------------------------------------

POD_MESH = ((2, 4, 8), ("pod", "data", "model"))
DM_MESH = ((4, 8), ("data", "model"))

# (logical axes, shape, mesh, rules name): tests/test_sharding_rules.py's
# nine cases, test_dist_extra.py's serve case, test_policy.py's hybrid
# cases
CASES = [
    (("embed", "ffn"), (16, 64), POD_MESH, "DEFAULT_RULES"),
    (("heads",), (6,), POD_MESH, "DEFAULT_RULES"),
    (("vocab",), (64,), POD_MESH, "DEFAULT_RULES"),
    (("vocab",), (12,), POD_MESH, "DEFAULT_RULES"),
    (("batch", None), (8, 5), POD_MESH, "DEFAULT_RULES"),
    (("batch", None), (8, 5), POD_MESH, "ISLAND_RULES"),
    (("ffn", "heads"), (64, 64), POD_MESH, "DEFAULT_RULES"),
    (("ffn", "expert_ffn"), (64, 64), POD_MESH, "DEFAULT_RULES"),
    ((("data", "model"), None), (32, 3), POD_MESH, "DEFAULT_RULES"),
    (("island", "embed"), (2, 16), POD_MESH, "DEFAULT_RULES"),
    (("island", "embed"), (2, 16), DM_MESH, "DEFAULT_RULES"),
    (("embed", "ffn"), (16, 64), DM_MESH, "SERVE_RULES"),
    (("vocab", "embed"), (64, 48), DM_MESH, "HYBRID_SERVE_RULES"),
    (("embed", "ffn"), (48, 64), DM_MESH, "HYBRID_SERVE_RULES"),
    (("embed", "heads", None), (48, 8, 16), DM_MESH, "HYBRID_SERVE_RULES"),
    (("vocab", "embed"), (24, 48), DM_MESH, "HYBRID_SERVE_RULES"),
    (("batch", ("model",), "kv_heads", None), (8, 64, 20, 16), DM_MESH,
     "SERVE_RULES"),
]


@pytest.mark.parametrize("axes,shape,mesh,rules", CASES)
def test_reference_sharding_cases(axes, shape, mesh, rules):
    jm, tm = _meshes(*mesh)
    want = jsh.logical_to_mesh_spec(axes, shape, jm, getattr(jsh, rules))
    got = sh.logical_to_mesh_spec(axes, shape, tm, getattr(sh, rules))
    assert isinstance(got, sh.PartitionSpec)
    assert _spec(got) == _spec(want)


def test_arch_registry_in_the_reference_order():
    from repro.configs import list_archs as jax_list_archs
    assert list_archs(assigned_only=True) == jax_list_archs()
    assert list_archs() == jax_list_archs(assigned_only=False)


def test_rule_sets_and_layout_factory_equal():
    for name in ("DEFAULT_RULES", "ISLAND_RULES", "SERVE_RULES",
                 "HYBRID_SERVE_RULES"):
        want, got = getattr(jsh, name), getattr(sh, name)
        assert dict(got) == dict(want) and got.priority == want.priority
    assert list(sh.SERVE_LAYOUTS) == list(jsh.SERVE_LAYOUTS)
    assert sh.serve_layout_rules("stationary") is sh.SERVE_RULES
    assert sh.serve_layout_rules("hybrid") is sh.HYBRID_SERVE_RULES
    with pytest.raises(KeyError):
        sh.serve_layout_rules("nope")


LOGICAL = [None, "batch", "island", "embed", "embed_tp", "ffn", "expert_ffn",
           "heads", "kv_heads", "vocab", "experts", "ssm_inner", "lru_width",
           "layers", "kv_seq", "unknown_axis", ("model",), ("data", "model"),
           ("pod", "data")]
MESH_AXES = ["pod", "data", "model"]


@pytest.mark.parametrize("seed", range(4))
def test_random_resolution_sweep_matches_reference(seed):
    """100 draws a seed of meshes, axes, shapes and rule sets: equal
    specs, equal FallbackRecords, the same warnings (both packages'
    warned-key sets reset first)."""
    rng = np.random.default_rng(seed)
    rule_names = ["DEFAULT_RULES", "ISLAND_RULES", "SERVE_RULES",
                  "HYBRID_SERVE_RULES"]
    jsh._warned_fallbacks.clear()
    sh._warned_fallbacks.clear()
    for _ in range(100):
        n_axes = int(rng.integers(1, 4))
        names = list(rng.choice(MESH_AXES, size=n_axes, replace=False))
        sizes = [int(rng.choice([1, 2, 3, 4, 8, 16])) for _ in names]
        jm, tm = _meshes(sizes, names)
        rank = int(rng.integers(1, 5))
        axes = tuple(LOGICAL[int(i)] for i in
                     rng.integers(0, len(LOGICAL), size=rank))
        shape = tuple(int(rng.choice([1, 2, 3, 6, 8, 16, 20, 24, 64]))
                      for _ in range(rank))
        rules = rule_names[int(rng.integers(len(rule_names)))]
        jrep, trep = [], []
        with warnings.catch_warnings(record=True) as jw:
            warnings.simplefilter("always")
            want = jsh.logical_to_mesh_spec(axes, shape, jm,
                                            getattr(jsh, rules), jrep)
        with warnings.catch_warnings(record=True) as tw:
            warnings.simplefilter("always")
            got = sh.logical_to_mesh_spec(axes, shape, tm,
                                          getattr(sh, rules), trep)
        assert _spec(got) == _spec(want), (axes, shape, names, sizes, rules)
        assert [r.as_dict() for r in trep] == [r.as_dict() for r in jrep]
        assert [str(w.message) for w in tw] == [str(w.message) for w in jw]
        assert all(w.category is sh.ShardingFallbackWarning for w in tw)
    assert sh._warned_fallbacks == jsh._warned_fallbacks
    jsh._warned_fallbacks.clear()
    sh._warned_fallbacks.clear()


def test_placements_on_an_abstract_and_a_device_mesh():
    from torch.distributed.tensor import Replicate, Shard
    tm = sh.AbstractMesh((4, 8), ("data", "model"))
    assert sh.placements(sh.PartitionSpec("data", None, "model"), tm) == \
        [Shard(0), Shard(2)]
    assert sh.placements(sh.PartitionSpec(None, ("model", "data")), tm) == \
        [Shard(1), Shard(1)]
    assert sh.placements(sh.PartitionSpec(None, None), tm) == \
        [Replicate(), Replicate()]
    # a DeviceMesh of one CPU process (gloo): names from mesh_dim_names
    import torch.distributed as dist
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        dm = tmesh.make_mesh((1, 1), ("data", "model"), device_type="cpu")
        assert sh.mesh_sizes(dm) == {"data": 1, "model": 1}
        spec = sh.logical_to_mesh_spec(("batch", "heads"), (4, 8), dm)
        assert _spec(spec) == ("data", "model")
        assert sh.placements(spec, dm) == [Shard(0), Shard(1)]
        assert sh.placements(sh.PartitionSpec(("data", "model"), None),
                             dm) == [Shard(0), Shard(0)]
        # constrain redistributes a DTensor to the resolved placements
        from torch.distributed.tensor import distribute_tensor
        x = distribute_tensor(torch.ones(4, 8), dm, [Replicate(),
                                                      Replicate()])
        with sh.use_mesh(dm):
            y = sh.constrain(x, ("batch", "heads"))
        assert list(y.placements) == [Shard(0), Shard(1)]
        with pytest.raises(RuntimeError, match="world size 1 != 4"):
            tmesh.make_mesh((2, 2), ("data", "model"))
    finally:
        dist.destroy_process_group()


def test_ambient_mesh_rules_and_constrain():
    x = torch.ones(4, 6)
    assert sh.constrain(x, ("batch", "ffn")) is x          # no mesh: no-op
    assert sh.mesh_axis_size("model") == 1
    tm = sh.AbstractMesh((2, 4), ("data", "model"))
    sh._warned_fallbacks.clear()
    with sh.use_mesh(tm), sh.use_rules(sh.SERVE_RULES):
        assert sh.current_rules() is sh.SERVE_RULES
        assert sh.mesh_axis_size("model") == 4
        assert sh.mesh_axis_size("pod") == 1
        with pytest.warns(sh.ShardingFallbackWarning):
            assert sh.constrain(torch.ones(2, 6), ("batch", "heads")) \
                .shape == (2, 6)
        spec = tcache.CacheSpec.parse("ring/bf16")
        assert tcache.ring_segments(spec, 64) == 4
    assert sh.current_rules() is sh.DEFAULT_RULES
    assert sh.ambient_mesh() is None
    sh._warned_fallbacks.clear()


def test_meshes_are_hopper_and_raise_without_a_process_group():
    assert tmesh.production_mesh_spec() == ((32, 8), ("data", "model"))
    assert tmesh.production_mesh_spec(multi_pod=True) == \
        ((2, 32, 8), ("pod", "data", "model"))
    for multi, n in ((False, 256), (True, 512)):
        m = tmesh.abstract_production_mesh(multi_pod=multi)
        assert m.size == n == jmesh.abstract_production_mesh(
            multi_pod=multi).size
        assert tmesh.n_islands(m) == (2 if multi else 1)
    assert sh.mesh_sizes(tmesh.make_host_mesh()) == {"data": 1, "model": 1}
    # every SHAPES global batch divides both meshes' batch axes
    for shape in SHAPES.values():
        if shape.global_batch >= 32:
            assert shape.global_batch % 32 == 0
    with pytest.raises(RuntimeError, match="not initialised"):
        tmesh.make_production_mesh()


# ---------------------------------------------------------------------------
# Cache and param defs (the repaired logical axes)
# ---------------------------------------------------------------------------

SPECS = [f"{lay}/{dt}" for lay in ("head", "ring", "replicated")
         for dt in ("bf16", "int8")]


def _leaf_rows(defs, is_def=None):
    if is_def is None:
        return [(tuple(d.shape), d.dtype.itemsize, tuple(d.logical_axes))
                for d in leaves(defs)]
    return [(tuple(d.shape), d.dtype.itemsize, tuple(d.logical_axes))
            for d in jax.tree.leaves(defs, is_leaf=is_def)]


@pytest.mark.parametrize("arch", list_archs())
def test_param_input_and_cache_defs_match_reference(arch):
    for tget, jget in ((get_config, jax_get_config),
                       (get_smoke_config, jax_smoke)):
        tm, jm = build_model(tget(arch)), jax_build(jget(arch))
        assert _leaf_rows(tm.param_defs()) == \
            _leaf_rows(jm.param_defs(), jax_is_def)
        for name, shape in SHAPES.items():
            assert _leaf_rows(tm.input_defs(shape)) == \
                _leaf_rows(jm.input_defs(JSHAPES[name]), jax_is_def)
        if tm._cache_defs is None:
            continue
        assert _leaf_rows(tm.cache_defs(2, 64)) == \
            _leaf_rows(jm.cache_defs(2, 64), jax_is_def)
        if not tm.supports_cache_spec:
            continue
        for spec in SPECS:
            assert _leaf_rows(tm.cache_defs(2, 64, spec=spec)) == \
                _leaf_rows(jm.cache_defs(2, 64, spec=spec), jax_is_def), spec
        # the paged pool: one sink block more than the reference's
        got = _leaf_rows(tm.paged_cache_defs(2, 8, 4, 8))
        want = _leaf_rows(jm.paged_cache_defs(2, 8, 4, 8), jax_is_def)
        for g, w in zip(got, want):
            if len(g[0]) == 5:
                assert g[0] == (w[0][0], w[0][1] + 1) + w[0][2:]
                assert g[1:] == w[1:]
            else:
                assert g == w


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "granite-20b",
                                  "mixtral-8x22b"])
def test_cache_resolve_and_bytes_match_reference(arch):
    tcfg, jcfg = get_config(arch), jax_get_config(arch)
    for sizes, names in REF_MESHES + (((1, 1), ("data", "model")),):
        jm, tm = _meshes(sizes, names)
        for spec in SPECS + ["ring:4/int8"]:
            assert tcache.resolve(spec, tcfg, tm)[1] == \
                jcache.resolve(spec, jcfg, jm)[1]
            for rules in ("SERVE_RULES", "DEFAULT_RULES"):
                assert tcache.cache_bytes(tcfg, 8, 4096, spec, tm,
                                          getattr(sh, rules)) == \
                    jcache.cache_bytes(jcfg, 8, 4096, spec, jm,
                                       getattr(jsh, rules))


def test_param_bytes_and_abstract_params():
    from repro.models.param import param_bytes as jpb
    from repro_torch.models.param import abstract_params, param_bytes
    for arch in ("granite-20b", "qwen3-moe-235b-a22b"):
        tm, jm = build_model(get_config(arch)), jax_build(
            jax_get_config(arch))
        assert param_bytes(tm.param_defs()) == jpb(jm.param_defs())
        meta = abstract_params(tm.param_defs())
        assert all(t.device.type == "meta" for t in leaves(meta))
        assert [(tuple(t.shape), t.dtype) for t in leaves(meta)] == \
            [(d.shape, d.dtype) for d in leaves(tm.param_defs())]


# ---------------------------------------------------------------------------
# Policy
# ---------------------------------------------------------------------------

GB = int(1e9)

# tests/test_policy.py's decide cases: (layouts, GB peaks, step s,
# budget, margin)
DECIDE = [
    (("stationary", "hybrid", "fsdp"), (10, 6, 2), (0.01, 0.02, 0.5),
     16e9, 0.9),
    (("stationary", "fsdp"), (15, 2), (0.01, 0.5), 16e9, 0.9),
    (("stationary", "fsdp"), (16e9 * 0.9 / GB, 1), (0.01, 1.0), 16e9, 0.9),
    (("stationary", "fsdp"), ((int(16e9 * 0.9) + 1) / GB, 1), (0.01, 1.0),
     16e9, 0.9),
    (("stationary", "hybrid", "fsdp"), (55, 27, 20), (0.07, 0.6, 0.6),
     16e9, 0.9),
    (("stationary", "hybrid", "fsdp"), (1, 1, 1), (0.1, 0.1, 0.1),
     16e9, 0.9),
]


@pytest.mark.parametrize("layouts,peaks,steps,budget,margin", DECIDE)
def test_decide_matches_reference(layouts, peaks, steps, budget, margin):
    jevals = [jpolicy.CandidateEval(l, p * GB, s)
              for l, p, s in zip(layouts, peaks, steps)]
    tevals = [policy.CandidateEval(l, p * GB, s)
              for l, p, s in zip(layouts, peaks, steps)]
    want = jpolicy.decide(jevals, budget_bytes=budget, margin=margin)
    got = policy.decide(tevals, budget_bytes=budget, margin=margin)
    assert (got.layout, got.fits, got.reason, got.headroom_bytes()) == \
        (want.layout, want.fits, want.reason, want.headroom_bytes())
    assert got.as_dict() == want.as_dict()
    with pytest.raises(ValueError):
        policy.decide([])


def test_eval_from_measured_and_default_budget():
    e = policy.eval_from_measured("stationary", {"peak_bytes": 5 * GB},
                                  {"bound_s": 0.25}, cache="head/int8")
    assert (e.hbm_bytes, e.step_time_s, e.source, e.key) == \
        (5 * GB, 0.25, "measured", "stationary+head/int8")
    d = policy.decide([e])
    assert d.budget_bytes == hardware.DEVICE_HBM_BYTES == 80e9
    assert d.fits and d.headroom_bytes() == 72e9 - 5 * GB


@pytest.mark.parametrize("arch", LMS)
def test_analytic_decisions_match_reference(arch):
    """Every serve shape x the reference's two meshes at its constants:
    the same key and fits, every candidate's bytes and detail equal, step
    times within 1e-12 relative, the same reason."""
    tm, jm = build_model(get_config(arch)), jax_build(jax_get_config(arch))
    for sizes, names in REF_MESHES:
        jmesh_, tmesh_ = _meshes(sizes, names)
        for name, shape in SHAPES.items():
            if shape.kind == "train":
                continue
            want = jpolicy.analytic_serve_decision(jm, JSHAPES[name],
                                                   jmesh_)
            got = policy.analytic_serve_decision(tm, shape, tmesh_,
                                                 hw=REF_HW)
            assert (got.key, got.fits) == (want.key, want.fits), name
            assert len(got.evals) == len(want.evals)
            for g, w in zip(got.evals, want.evals):
                assert (g.key, g.hbm_bytes, g.detail) == \
                    (w.key, w.hbm_bytes, w.detail), (name, g.key)
                assert g.step_time_s == pytest.approx(w.step_time_s,
                                                      rel=1e-12)
            assert got.reason == want.reason


def test_check_fit_prints_the_reference_lines():
    """The reference's `--check-fit --mesh both` (a subprocess: its module
    sets a 512-device XLA flag at import) against the port's check_fit
    at the reference's constants and meshes."""
    ref = _run("repro.launch.dryrun", "--check-fit", "--mesh", "both")
    tout = io.StringIO()
    with contextlib.redirect_stdout(tout):
        tcode = dryrun.check_fit(("single", "multi"), hw=REF_HW,
                                 mesh_spec=jmesh.production_mesh_spec)
    assert tcode == ref.returncode
    assert tout.getvalue().splitlines() == ref.stdout.splitlines()
    assert len(tout.getvalue().splitlines()) > 40


def test_analytic_prefill_baseline_excludes_cache_bytes():
    """tests/test_cache_spec.py's case: the spec-less prefill eval keeps
    the cache out of the peak, a spec'd one counts it."""
    tm = sh.AbstractMesh((4, 8), ("data", "model"))
    model = build_model(get_smoke_config("granite-20b"))
    shape = dataclasses.replace(SHAPES["prefill_32k"], global_batch=8)
    plain = policy.analytic_eval(model, shape, tm, "fsdp")
    spec = policy.analytic_eval(model, shape, tm, "fsdp",
                                cache_spec="head/bf16")
    assert plain.detail["cache_bytes"] == 0.0
    assert spec.detail["cache_bytes"] > 0.0
    assert spec.hbm_bytes > plain.hbm_bytes


def test_serve_product_candidates_match_reference():
    for arch in LMS:
        tm, jm = build_model(get_smoke_config(arch)), jax_build(
            jax_smoke(arch))
        for name, shape in SHAPES.items():
            assert policy.serve_product_candidates(tm, shape) == \
                jpolicy.serve_product_candidates(jm, JSHAPES[name])
    assert policy.CACHE_SPEC_CANDIDATES == jpolicy.CACHE_SPEC_CANDIDATES
    assert policy.CHUNK_TOKENS == jpolicy.CHUNK_TOKENS


def test_full_width_granite_decisions_on_one_card():
    """On one H100 at 48 slots x 32,768 positions head/bf16 is over the
    72 GB cap and the policy picks head/int8; at 32 slots head/bf16."""
    model = build_model(get_config("granite-20b"))
    host = tmesh.make_host_mesh()
    d48 = policy.analytic_serve_decision(
        model, dataclasses.replace(SHAPES["decode_32k"], global_batch=48),
        host)
    assert d48.key == "stationary+head/int8" and d48.fits
    assert d48.evals[0].key == "stationary+head/bf16"
    assert round(d48.evals[0].hbm_bytes / 1e9, 2) == 82.51
    assert round(d48.chosen.detail["cache_bytes"] / 1e9, 2) == 21.59
    d32 = policy.analytic_serve_decision(
        model, dataclasses.replace(SHAPES["decode_32k"], global_batch=32),
        host)
    assert d32.key == "stationary+head/bf16"
    assert round(d32.chosen.hbm_bytes / 1e9, 2) == 68.55


def test_host_mesh_is_one_card_on_a_many_card_host(monkeypatch):
    """The port places every tensor on one card, so a host that shows 4
    cards still gives a (1, 1) host mesh and the one-card decision."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    host = tmesh.make_host_mesh()
    assert sh.mesh_sizes(host) == {"data": 1, "model": 1}
    model = build_model(get_config("granite-20b"))
    d48 = policy.analytic_serve_decision(
        model, dataclasses.replace(SHAPES["decode_32k"], global_batch=48),
        host)
    assert d48.key == "stationary+head/int8"
    assert round(d48.chosen.detail["cache_bytes"] / 1e9, 2) == 21.59


# ---------------------------------------------------------------------------
# Serve: pick_layout, the loops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout,cache", [("auto", "auto"),
                                          ("fsdp", "auto"),
                                          ("auto", "head/int8"),
                                          ("hybrid", "ring:2/int8")])
@pytest.mark.parametrize("arch", ["granite-20b", "falcon-mamba-7b",
                                  "qwen3-moe-235b-a22b"])
def test_pick_layout_matches_reference(arch, layout, cache):
    tm, jm = build_model(get_smoke_config(arch)), jax_build(jax_smoke(arch))
    want = jserve.pick_layout(jm, jmesh.make_host_mesh(), batch=4,
                              seq_len=96, layout=layout, cache=cache)
    got = serve.pick_layout(tm, tmesh.make_host_mesh(), batch=4, seq_len=96,
                            layout=layout, cache=cache, hw=REF_HW)
    assert (got.key, got.fits, got.reason) == \
        (want.key, want.fits, want.reason)
    assert [(e.key, e.hbm_bytes) for e in got.evals] == \
        [(e.key, e.hbm_bytes) for e in want.evals]


def test_serve_main_prints_the_decision(capsys):
    serve.main(["--device", "cpu", "--gen", "3", "--batch", "2",
                "--prompt-len", "9"])
    out = capsys.readouterr().out
    assert "[serve] layout=stationary cache=head/bf16 (peak " in out
    res = serve.main(["--device", "cpu", "--gen", "3", "--batch", "2",
                      "--prompt-len", "9", "--layout", "fsdp",
                      "--cache", "head/int8"])
    assert res["decision"].key == "fsdp+head/int8"
    assert "k_scale" in res["cache"]
    # the predicted cache bytes are the allocated ones
    assert res["decision"].chosen.detail["cache_bytes"] == sum(
        t.numel() * t.element_size() for t in leaves(res["cache"]))


def test_serve_loop_under_a_small_budget_picks_the_reference_spec(
        monkeypatch):
    """A budget between granite smoke's head/bf16 and head/int8 peaks,
    patched into both packages: both ServeLoop(mesh=) pick head/int8, and
    the streams agree under serve_load.divergence."""
    from test_torch_moe import _record_jax
    arch = "granite-20b"
    tm, jm = build_model(get_smoke_config(arch)), jax_build(jax_smoke(arch))
    shape = dataclasses.replace(SHAPES["decode_32k"], seq_len=64,
                                global_batch=2)
    evals = {e.key: e.hbm_bytes for e in policy.analytic_serve_decision(
        tm, shape, tmesh.make_host_mesh()).evals}
    budget = (evals["stationary+head/bf16"]
              + evals["stationary+head/int8"]) / 2 / 0.9
    monkeypatch.setattr(jpolicy, "analytic_serve_decision", functools.partial(
        jpolicy.analytic_serve_decision, budget_bytes=budget))
    monkeypatch.setattr(policy, "analytic_serve_decision", functools.partial(
        policy.analytic_serve_decision, budget_bytes=budget))
    jp = jm.init(jax.random.key(0))
    jloop = JaxServeLoop(jm, jp, max_batch=2, max_len=64,
                         mesh=jmesh.make_host_mesh())
    tloop = ServeLoop(tm, from_reference(jp), max_batch=2, max_len=64,
                      mesh=tmesh.make_host_mesh())
    assert tloop.cache_spec == jloop.cache_spec == "head/int8"
    assert tloop.layout_decision.key == jloop.layout_decision.key
    assert "k_scale" in tloop.cache
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tm.cfg.vocab_size, n).astype(np.int32)
               for n in (12, 7, 19)]
    want_rows, got_rows = _record_jax(jloop), serve_load.record_logits(tloop)
    for i, p in enumerate(prompts):
        jloop.submit(JaxRequest(rid=i, prompt=p, max_new=5))
        tloop.submit(Request(rid=i, prompt=p, max_new=5))
    want = {r.rid: r.out for r in jloop.run_until_drained()}
    got = {r.rid: r.out for r in tloop.run_until_drained()}
    verdicts = [serve_load.divergence(got[i], want[i], got_rows[i],
                                      want_rows[i]) for i in range(3)]
    assert all(kind != "mismatch" for kind, _ in verdicts), verdicts


def test_forced_layout_sets_rules_and_paged_loop_takes_a_mesh():
    from repro_torch.launch.serve_loop import PagedServeLoop
    model = build_model(get_smoke_config("granite-20b"))
    from repro_torch import threefry
    params = model.init(threefry.key(0), "cpu")
    loop = ServeLoop(model, params, max_batch=2, max_len=32, layout="fsdp")
    assert loop.rules is sh.DEFAULT_RULES and loop.layout_decision is None
    ploop = PagedServeLoop(model, params, max_batch=2, num_blocks=8,
                           block_size=8, chunk=16,
                           mesh=tmesh.make_host_mesh())
    assert ploop.layout_decision.layout == "stationary"
    ploop.submit(Request(rid=0, prompt=np.arange(5, dtype=np.int32),
                         max_new=3))
    assert len(ploop.run_until_drained()[0].out) == 3


# ---------------------------------------------------------------------------
# The dry run's CLI and its readers
# ---------------------------------------------------------------------------

def _run(*args, cwd=ROOT):
    return subprocess.run([sys.executable, "-m", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=600,
                          env={**os.environ,
                               "PYTHONPATH": str(ROOT / "src"),
                               "JAX_PLATFORMS": "cpu"})


def test_check_fit_cli_on_the_hopper_meshes():
    r = _run("repro_torch.launch.dryrun", "--check-fit", "--mesh", "both")
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "every serve cell has >=1 fitting (weight, cache) layout" in \
        r.stdout
    lines = [l for l in r.stdout.splitlines() if l.startswith("[check-fit] ")
             and "GB" in l]
    assert len(lines) == 46 and all(l.endswith(" ok") for l in lines)


def test_one_cell_artifact_and_its_readers(tmp_path):
    r = _run("repro_torch.launch.dryrun", "--arch", "granite-20b",
             "--shape", "decode_32k", "--mesh", "single", "--out",
             str(tmp_path))
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    rec = json.loads((tmp_path / "granite-20b__decode_32k__single.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["mesh_shape"] == {"data": 32,
                                                           "model": 8}
    e = rec["entries"]["decode_step"]
    assert e["traced"] and e["diagnostics"] == []
    assert e["cost"]["flops"] > 0 and e["cost"]["hbm_bytes"] > 0
    assert e["roofline"]["dominant"] == "memory"
    assert all(c["source"] == "analytic"
               for c in rec["layout_decision"]["candidates"])
    rows = roofline.main(["--dir", str(tmp_path)])
    assert [r["arch"] for r in rows] == ["granite-20b"]
    assert rows[0]["bound_s"] == e["roofline"]["bound_s"]
    md = gen_experiments.main(["--dir", str(tmp_path), "--out",
                               str(tmp_path / "planning.md")])
    assert "| granite-20b | decode_32k | single | **stationary** |" in md
    assert "| granite-20b | decode_32k |" in roofline.markdown_table(rows)


def test_untraceable_step_is_an_error_cell(monkeypatch):
    from repro_torch.launch import steps as S

    def syncing(model):
        def step(params, batch, cache):
            return batch["tokens"].sum().item(), cache
        return step
    monkeypatch.setattr(S, "make_decode_step", syncing)
    res = dryrun.run_cell("qwen1.5-4b", "decode_32k", "single")
    assert res["status"] == "error"
    assert "_local_scalar_dense" in res["traceback"]
    skipped = dryrun.run_cell("granite-20b", "long_500k", "single")
    assert skipped["status"] == "skipped"
    assert skipped["reason"] == ("full quadratic attention at 524288 "
                                 "tokens; long-context runs only for "
                                 "ssm/hybrid/windowed archs (DESIGN.md SS6)")

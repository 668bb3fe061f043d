"""BENCHMARK.json against the benchmark's contract, and the harness finding
every file a name in it points to."""
import json
import math
import re

import pytest

from portbench import core

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
WIDTH = re.compile(r"(_dim|_rank)$|^(hidden_size|intermediate_size|n_embd|"
                   r"n_inner|d_model|d_ff|head_size|num_experts_per_tok)$|"
                   r"latent|state_size|projection|expan")


@pytest.fixture(scope="module")
def manifest():
    return core.load_manifest()


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert len((core.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(manifest["command"]) <= 32
    assert all(_line(w) for w in manifest["command"])
    assert 1 <= len(manifest["paths"]) <= 16
    for p in manifest["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (core.ROOT / p).is_dir()
    r = manifest["run_seconds"]
    assert isinstance(r, int) and 1 <= r <= 51
    # a full check of 24 cells fits the driver's 43,200 seconds
    assert (2 + 14 * 24) * (r + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_lines(manifest):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in manifest[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for k in ("why", "layer", "source"):
                if k in e and group != "end_to_end" and group != "per_layer":
                    assert _line(e[k])
            if group == "per_layer":
                assert _line(e["layer"])
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        ns = [n for g, n in names if g == group]
        assert len(ns) == len(set(ns)), group
    metric_names = [e["name"] for e in manifest["end_to_end"]
                    + manifest["per_layer"]]
    assert len(metric_names) == len(set(metric_names))


def test_entry_keys(manifest):
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in manifest["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
    for m in manifest["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_configs(manifest):
    used = {w["config"] for w in manifest["workloads"]}
    files = set()
    for c in manifest["configs"]:
        assert c["name"] in used
        assert c["file"].startswith(tuple(p + "/" for p in manifest["paths"]))
        assert c["file"] not in files
        files.add(c["file"])
        body = json.loads((core.ROOT / c["file"]).read_text())
        assert body["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k) and not WIDTH.search(k), k
        assert body["as_run"]["dtype"] == "bfloat16"


def test_cells(manifest):
    cells = manifest["workloads"]
    assert 1 <= len(cells) <= 24
    pairs = [(w["config"], w["traffic"]) for w in cells]
    assert len(pairs) == len(set(pairs))
    assert all(w["chips"] in (1, 4) for w in cells)
    four = sum(w["chips"] == 4 for w in cells)
    assert four <= max(1, len(cells) // 4)
    for w in cells:
        e2e = {m["name"] for m in core.end_to_end_for(manifest, w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert core.per_layer_for(manifest, w["name"]), w["name"]


def test_bounds(manifest):
    for m in manifest["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m["name"]
    assert any(m["name"] == "setup_s" for m in manifest["end_to_end"])


def test_per_layer_moves_a_metric_every_listed_cell_reports(manifest):
    cells = {w["name"] for w in manifest["workloads"]}
    for m in manifest["per_layer"]:
        assert m["moves"] in {e["name"] for e in manifest["end_to_end"]}
        for w in m.get("workloads", cells):
            assert w in cells
            e2e = {e["name"] for e in core.end_to_end_for(manifest, w)}
            assert m["moves"] in e2e, (m["name"], w)
    for group in ("end_to_end",):
        for m in manifest[group]:
            for w in m.get("workloads", ()):
                assert w in cells


def test_layers_agree_letter_for_letter(manifest):
    by_layer = {}
    for m in manifest["per_layer"]:
        by_layer.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())


def test_rooflines_and_mfu_are_named_by_the_rule(manifest):
    names = [m["name"] for m in manifest["per_layer"]]
    assert "mfu.train" in names
    for m in manifest["per_layer"]:
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_harness_finds_every_file_by_name(manifest):
    for w in manifest["workloads"]:
        tr = core.traffic_of(w["traffic"])
        assert core.driver(tr["driver"]).run
        assert core.limits_of(w["name"])
        cfg = core.config_of(manifest, w["config"])
        fam = cfg["as_run"]["family"]
        assert core.layout(fam).leaves(cfg["as_run"])
        assert core.reference(fam).block
    for m in manifest["per_layer"]:
        assert callable(core.metric_reader(m["name"]))


def test_the_command_runs_the_harness(manifest):
    assert manifest["command"][:3] == ["python3", "-m", "portbench.run"]
    assert all(not w.startswith("/") and ".." not in w
               for w in manifest["command"])


def test_qwen_cut_holds_the_published_widths(manifest):
    cfg = core.config_of(manifest, "qwen1.5-4b-fl8")
    a = cfg["as_run"]
    assert (a["d_model"], a["d_ff"], a["num_heads"], a["num_kv_heads"],
            a["head_dim"], a["vocab_size"]) == (
        cfg["hidden_size"], cfg["intermediate_size"],
        cfg["num_attention_heads"], cfg["num_key_value_heads"],
        cfg["hidden_size"] // cfg["num_attention_heads"], cfg["vocab_size"])
    assert a["num_layers"] == cfg["num_hidden_layers"] == 8
    assert a["rope_theta"] == cfg["rope_theta"]
    lay = core.layout("dense")
    assert math.isclose(lay.n_params(a), 1.41e9, rel_tol=0.01)


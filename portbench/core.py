"""What every cell's run shares: the manifest and the files it names, the
run's record (spans, counters, facts, trace) and the result line."""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import importlib.util
import json
import time
from pathlib import Path
from typing import Any

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent                      # the checkout

#: top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_manifest(path: Path | None = None) -> dict:
    return json.loads((path or ROOT / "BENCHMARK.json").read_text())


def workload(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_of(manifest: dict, name: str) -> dict:
    for c in manifest["configs"]:
        if c["name"] == name:
            return json.loads((ROOT / c["file"]).read_text())
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic_of(name: str) -> dict:
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


def limits_of(workload_name: str) -> dict:
    return json.loads((BENCH / "limits" / f"{workload_name}.json")
                      .read_text())


def _load_path(path: Path, modname: str):
    spec = importlib.util.spec_from_file_location(modname, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """metrics/<name>.py (a name may hold dots) -> its `read(run)`."""
    path = BENCH / "metrics" / f"{name}.py"
    return _load_path(path, "portbench_metric_" + name.replace(".", "_")
                      .replace("-", "_")).read


def driver(name: str):
    return importlib.import_module(f"portbench.drivers.{name}")


def layout(family: str):
    return importlib.import_module(f"portbench.layouts.{family}")


def reference(family: str):
    return importlib.import_module(f"portbench.reference.{family}")


def end_to_end_for(manifest: dict, wname: str) -> list[dict]:
    return [m for m in manifest["end_to_end"]
            if "workloads" not in m or wname in m["workloads"]]


def per_layer_for(manifest: dict, wname: str) -> list[dict]:
    e2e = {m["name"] for m in end_to_end_for(manifest, wname)}
    return [m for m in manifest["per_layer"]
            if (wname in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]


def forbidden_modules(modules) -> list[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (`repro_torch` is not `repro`)."""
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN})


@dataclasses.dataclass
class Record:
    """What a run observed: host spans (perf_counter seconds), counters,
    facts the readers need (shapes, sizes), the device trace of the
    profiled sub-window, the window's memory peak and its metrics."""
    spans: list = dataclasses.field(default_factory=list)
    counters: dict = dataclasses.field(default_factory=dict)
    facts: dict = dataclasses.field(default_factory=dict)
    trace: Any = None
    peak_bytes: int = 0
    end_to_end: dict = dataclasses.field(default_factory=dict)

    def add(self, name: str, t0: float, t1: float, **attrs):
        self.spans.append((name, t0, t1, attrs))

    def durations(self, name: str) -> list:
        """Spans of the window outside the profiled sub-window (which the
        profiler's own work slows)."""
        return [t1 - t0 for n, t0, t1, a in self.spans
                if n == name and a.get("in_window") and not a.get("traced")]

@contextlib.contextmanager
def patched(module, **attrs):
    """Replace module globals for the duration of a block."""
    old = {k: getattr(module, k) for k in attrs}
    for k, v in attrs.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(module, k, v)


def now() -> float:
    return time.perf_counter()


@dataclasses.dataclass
class Run:
    """One run of one cell: what it is given and what it records."""
    workload: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: Any                     # torch.device
    record: Record = dataclasses.field(default_factory=Record)

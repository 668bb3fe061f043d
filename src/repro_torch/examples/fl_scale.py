"""FL simulation throughput of the scenario engine on the port: the
workload of the JAX package's benchmarks/fl_scale.py.

Rounds/s (sync) and merges/s (async) of `core.scenarios.ScenarioSim` at
10^3 and 10^5 simulated workers under the full churn + straggler +
non-IID-drift load (seed 1, 5 % participation, cohorts of 16, the
reference's `scenario-mlp`).  Each cell times the WHOLE loop, the sim's
construction included: vectorized population timing, shard synthesis and
its copy to the device, the vmapped cohort train step, the
edge->fog->cloud fold (sync) or the staleness merge (async, one `fed_agg`
launch a merge on the card), and evaluation.  One sync round and one
async merge run first, outside the timer, so no cell pays a kernel build.

Per cell it records the fed_agg launches counted around the run and
prints the card's name and power limit beside every wall time.  The
result goes to artifacts/fl_scale_torch.json (never to BENCH_fl.json,
whose rates are the JAX engine's on another host).

  PYTHONPATH=src python -m repro_torch.examples.fl_scale [--device cpu]
"""
from __future__ import annotations

import argparse
import hashlib
import json
import time
from pathlib import Path

from repro_torch.core.scenarios import ScenarioConfig, ScenarioSim
from repro_torch.kernels.fed_agg.kernel import fed_agg_grouped_cuda
from repro_torch.runtime import card_label, resolve_device, synchronize

OUT_PATH = Path(__file__).resolve().parents[3] / "artifacts" / \
    "fl_scale_torch.json"
WORKERS = (1_000, 100_000)
SYNC_ROUNDS = 5
ASYNC_MERGES = 64


def scenario(n_workers: int) -> ScenarioConfig:
    return ScenarioConfig(
        n_workers=n_workers, cohort_size=16, participation=0.05,
        churn_leave=0.02, churn_join=0.02, straggler_frac=0.05, drift=0.3,
        dirichlet_alpha=0.5, epochs=1, samples_per_worker=64, seed=1)


def stream_digest(result) -> str:
    """A digest of the time / round / n_selected / version columns of a
    run's records (float reprs round-trip exactly): equal digests, equal
    streams."""
    cols = [(r.time, r.round, r.n_selected, r.version)
            for r in result.records]
    return hashlib.sha256(repr(cols).encode()).hexdigest()[:16]


def warm_up(n_workers: int, device):
    """One sync round and one async merge, untimed: cuDNN and the
    fed_agg library load before any timed cell."""
    ScenarioSim(scenario(n_workers), device=device).run_sync(1)
    ScenarioSim(scenario(n_workers), device=device).run_async(1)


def run_cell(n_workers: int, mode: str, device="cuda", *, model_cfg=None,
             impl: str = "auto"):
    """One timed cell: build the sim and run it -> (SimResult, wall s,
    fed_agg launches counted around the run)."""
    cfg = scenario(n_workers)
    synchronize(device)
    before = fed_agg_grouped_cuda.launches
    t0 = time.perf_counter()
    sim = ScenarioSim(cfg, model_cfg=model_cfg, device=device, impl=impl)
    res = sim.run_sync(SYNC_ROUNDS) if mode == "sync" else \
        sim.run_async(ASYNC_MERGES)
    synchronize(device)
    wall = time.perf_counter() - t0
    return res, wall, fed_agg_grouped_cuda.launches - before


def measure(n_workers: int, device="cuda") -> tuple[dict, dict]:
    """The sync and async cells at `n_workers` -> (cells as the JSON
    holds them, {cell name: SimResult})."""
    warm_up(n_workers, device)
    cells, results = {}, {}
    for mode, steps, key in (("sync", SYNC_ROUNDS, "rounds"),
                             ("async", ASYNC_MERGES, "merges")):
        res, wall, launches = run_cell(n_workers, mode, device)
        name = f"{mode}_n{n_workers}"
        results[name] = res
        cells[name] = {"workers": n_workers, key: steps,
                       "wall_s": round(wall, 3),
                       "rounds_per_s": round(steps / wall, 3),
                       "best_acc": round(res.best_acc, 4),
                       "fed_agg_launches": launches}
    return cells, results


def run_all(device="cuda") -> tuple[dict, dict]:
    cells, results = {}, {}
    for n in WORKERS:
        print(f"[fl_scale] measuring n_workers={n} ...", flush=True)
        c, r = measure(n, device)
        cells.update(c)
        results.update(r)
    return {"bench": "fl_scale",
            "scenario": "churn+stragglers+non-IID drift, 5% participation",
            "device": card_label(device), "cells": cells}, results


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=str(OUT_PATH))
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    result, _ = run_all(device)
    for name, cell in result["cells"].items():
        print(f"[fl_scale] {name}: {cell['rounds_per_s']} rounds/s "
              f"({cell['wall_s']} s wall on {result['device']}, best_acc "
              f"{cell['best_acc']}, {cell['fed_agg_launches']} fed_agg "
              "launches)", flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=2, sort_keys=True) + "\n")
    print(f"[fl_scale] wrote {out}")
    return result


if __name__ == "__main__":
    main()

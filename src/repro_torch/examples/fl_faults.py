"""Byzantine robustness of the scenario engine on the port: the workload
of the JAX package's benchmarks/fl_faults.py.

Runs `core.scenarios.ScenarioSim` under a seeded 20 %-Byzantine fault
plan (sign-flip + 10x scale blow-up, core/faults.py) and compares
aggregators over 50 sync rounds (200 workers, cohorts of 12, one fog
cell, seed 3):

  clean_fedavg      no faults, weighted FedAvg        (the reference)
  attacked_fedavg   faults + weighted FedAvg          (must degrade)
  attacked_trimmed  faults + coordinate trimmed mean  (within ACC_TOL)
  attacked_krum     faults + multi-Krum               (within ACC_TOL)
  attacked_median   faults + coordinate median        (within ACC_TOL)
  attacked_nonfinite  nan/inf spray + plain FedAvg: the sanitization gate
                      alone must keep the published model finite

Invariants, checked on every run (exit 1 when one fails):
  * every cell's final server params are finite;
  * each robust aggregator's best accuracy is within ACC_TOL (2 points)
    of the fault-free run;
  * plain FedAvg under attack loses at least DEGRADE_MIN best accuracy.

The result goes to artifacts/fl_faults_torch.json, with the card's name
and power limit beside the wall times.

  PYTHONPATH=src python -m repro_torch.examples.fl_faults [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.core.scenarios import ScenarioConfig, ScenarioSim
from repro_torch.runtime import card_label, resolve_device, synchronize
from repro_torch.tree import leaves

OUT_PATH = Path(__file__).resolve().parents[3] / "artifacts" / \
    "fl_faults_torch.json"
ACC_TOL = 0.02            # robust agg must stay within 2 points of clean
DEGRADE_MIN = 0.10        # plain FedAvg under attack must lose >= this

ROUNDS = 50
BASE = dict(n_workers=200, cohort_size=12, fog_cells=1, participation=0.2,
            samples_per_worker=96, epochs=2, dirichlet_alpha=100.0, seed=3)
ATTACK = dict(byzantine_frac=0.2, byzantine_attacks=("sign_flip", "scale"),
              byzantine_scale=10.0)

CELLS = {
    "clean_fedavg": {},
    "attacked_fedavg": dict(ATTACK),
    "attacked_trimmed": {**ATTACK, "robust_agg": "trimmed_mean",
                         "trim_frac": 0.3},
    "attacked_krum": {**ATTACK, "robust_agg": "krum"},
    "attacked_median": {**ATTACK, "robust_agg": "median"},
    "attacked_nonfinite": {**ATTACK,
                           "byzantine_attacks": ("nan", "inf")},
}


def measure(knobs: dict, device="cuda") -> dict:
    """One cell -> its JSON record."""
    cfg = ScenarioConfig(**BASE, **knobs)
    sim = ScenarioSim(cfg, pool=2048, eval_n=512, device=device)
    synchronize(device)
    t0 = time.perf_counter()
    res = sim.run_sync(ROUNDS)
    synchronize(device)
    wall = time.perf_counter() - t0
    accs = [r.acc for r in res.records]
    finite = all(bool(torch.isfinite(l).all())
                 for l in leaves(res.final_params))
    return {
        "rounds": ROUNDS,
        "robust_agg": knobs.get("robust_agg", "none"),
        "byzantine_frac": knobs.get("byzantine_frac", 0.0),
        "best_acc": round(res.best_acc, 4),
        "final_acc": round(float(np.mean(accs[-3:])), 4),
        "params_finite": finite,
        "n_quarantined": len(sim.quarantine),
        "wall_s": round(wall, 3),
    }


def run_all(device="cuda") -> dict:
    cells = {}
    for name, knobs in CELLS.items():
        print(f"[fl_faults] measuring {name} ...", flush=True)
        cells[name] = measure(knobs, device)
    return {
        "bench": "fl_faults",
        "scenario": (f"{BASE['n_workers']} workers, cohort "
                     f"{BASE['cohort_size']}, 20% Byzantine "
                     "(sign_flip + 10x scale)"),
        "acc_tol": ACC_TOL,
        "degrade_min": DEGRADE_MIN,
        "device": card_label(device),
        "cells": cells,
    }


def check_invariants(result: dict) -> list[str]:
    cells = result["cells"]
    clean = cells["clean_fedavg"]["best_acc"]
    failures = []
    for name, cell in cells.items():
        if not cell["params_finite"]:
            failures.append(f"{name}: non-finite server params")
    for name in ("attacked_trimmed", "attacked_krum", "attacked_median"):
        deficit = clean - cells[name]["best_acc"]
        status = "OK" if deficit <= ACC_TOL else "VIOLATED"
        print(f"[fl_faults] {name}: best_acc {cells[name]['best_acc']} "
              f"(clean {clean}, deficit {deficit:.4f} <= {ACC_TOL}) "
              f"{status}")
        if status == "VIOLATED":
            failures.append(f"{name}: deficit {deficit:.4f} > {ACC_TOL}")
    drop = clean - cells["attacked_fedavg"]["best_acc"]
    status = "OK" if drop >= DEGRADE_MIN else "VIOLATED"
    print(f"[fl_faults] attacked_fedavg: best_acc "
          f"{cells['attacked_fedavg']['best_acc']} (degradation "
          f"{drop:.4f} >= {DEGRADE_MIN}) {status}")
    if status == "VIOLATED":
        failures.append(
            f"attacked_fedavg: attack too weak (drop {drop:.4f})")
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=str(OUT_PATH))
    args = ap.parse_args(argv)
    result = run_all(resolve_device(args.device))
    for name, cell in result["cells"].items():
        print(f"[fl_faults] {name}: best_acc {cell['best_acc']} "
              f"final {cell['final_acc']} finite {cell['params_finite']} "
              f"quarantined {cell['n_quarantined']} ({cell['wall_s']} s "
              f"wall on {result['device']})", flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=2, sort_keys=True) + "\n")
    print(f"[fl_faults] wrote {out}")
    failures = check_invariants(result)
    if failures:
        print(f"[fl_faults] FAIL: invariant violations: {failures}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

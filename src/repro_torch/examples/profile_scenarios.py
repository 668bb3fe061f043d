"""Where the 10^5-worker scenario loop's time goes on the card.

Runs fl_scale's 10^5-worker scenario (examples/fl_scale.py: 5 sync rounds,
then 64 async merges) with each layer's host time taken between
synchronisations, as self time (a layer's inner layers are taken out of
it; `profile_quickstart.layer_times`):

  setup        the sim's construction: datasets, population arrays
  population   churn and selection over the whole fleet (numpy)
  shards       shard synthesis (numpy)
  orders       batch orders from the Threefry keys (numpy)
  copy         stacking the shards and copying them to the device
  training     the vmapped cohort train step
  faults       fault injection and the finite scan (none in fl_scale)
  fold         the sync edge->fog->cloud fold
  merge        the async staleness merge (one fed_agg launch)
  evaluation   accuracy on the device-resident test set
  engine       the rest: the straggler barrier, the heap, records

then the same two runs under `torch.profiler` for the device's busy share
and its kernels by name.  One sync round and one async merge run first,
untimed.

  PYTHONPATH=src python -m repro_torch.examples.profile_scenarios \
      [--device cpu] [--workers N]
"""
from __future__ import annotations

import argparse

from repro_torch.core import aggregation, federated
from repro_torch.core.client import LocalTrainer
from repro_torch.core.scenarios import ScenarioSim
from repro_torch.examples.fl_scale import (ASYNC_MERGES, SYNC_ROUNDS,
                                           scenario, warm_up)
from repro_torch.examples.profile_quickstart import (device_profile,
                                                     layer_times, report,
                                                     report_kernels)
from repro_torch.runtime import card_label, resolve_device

# (owner, attribute, label); federated.draw_orders is the name
# cohort_train calls, so patching it there reaches the call
LAYERS = ((ScenarioSim, "__init__", "setup"),
          (ScenarioSim, "_churn", "population"),
          (ScenarioSim, "_select", "population"),
          (ScenarioSim, "shard_for", "shards"),
          (federated, "draw_orders", "orders"),
          (federated, "cohort_train", "copy"),
          (LocalTrainer, "train_cohort", "training"),
          (ScenarioSim, "_inject_and_sanitize", "faults"),
          (ScenarioSim, "_fold_cohort", "fold"),
          (aggregation, "async_merge", "merge"),
          (ScenarioSim, "_eval", "evaluation"))


def runs(n_workers: int, device):
    """fl_scale's two runs at n_workers: 5 sync rounds, 64 async merges."""
    ScenarioSim(scenario(n_workers), device=device).run_sync(SYNC_ROUNDS)
    ScenarioSim(scenario(n_workers), device=device).run_async(ASYNC_MERGES)


def breakdown(n_workers: int, device) -> dict[str, float]:
    """Seconds by layer of one pass of `runs`, after an untimed warm-up."""
    warm_up(n_workers, device)
    with layer_times(LAYERS, device) as bucket:
        runs(n_workers, device)
    return dict(bucket)


def main(argv=None) -> dict[str, float]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--workers", type=int, default=100_000)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    bucket = breakdown(args.workers, device)
    report(f"scenario loop, {args.workers} workers, {SYNC_ROUNDS} sync "
           f"rounds + {ASYNC_MERGES} async merges ({card_label(device)})",
           bucket)
    if device.type != "cuda":
        print("device busy share: not measured (no card)")
    else:
        report_kernels(*device_profile(lambda: runs(args.workers, device)))
    return bucket


if __name__ == "__main__":
    main()

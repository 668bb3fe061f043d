"""Quickstart: a complete FLight run on the PyTorch port.

Five heterogeneous workers federate a CNN on private synMNIST shards with
Algorithm 2 (training-time-based) selection, asynchronously: the fleet,
policy and 80 merges of the JAX package's examples/quickstart.py.  Every
merge runs through the fed_agg kernel on the card.

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

from repro_torch import threefry
from repro_torch.configs import get_config
from repro_torch.core.client import LocalTrainer, SimWorker
from repro_torch.core.cost_model import heterogeneous_profiles, make_stats
from repro_torch.core.events import FLSimulation, SimResult
from repro_torch.core.server import AggregationServer, ServerConfig
from repro_torch.data.partition import partition_by_batches
from repro_torch.data.synthetic import make_classification_set
from repro_torch.kernels.fed_agg.kernel import fed_agg_cuda
from repro_torch.models import build_model
from repro_torch.runtime import resolve_device


def make_simulation(device="cuda", *, policy: str = "time_based",
                    mode: str = "async", seed: int = 0,
                    impl: str = "auto") -> FLSimulation:
    """The quickstart fleet; `impl="ref"` merges through fed_agg's plain
    version instead of the kernel (a reference run on the same card)."""
    dev = resolve_device(device)
    # 1. model + private data shards (batches per worker: uneven on purpose)
    model = build_model(get_config("flight-cnn-mnist"))
    images, labels = make_classification_set("synmnist", 8192, seed=seed)
    shards = partition_by_batches(images, labels, [4, 2, 2, 1, 1],
                                  batch_size=64)
    # 2. heterogeneous fleet (speeds 1-4x) + the server's Eq.4 estimates
    profiles = heterogeneous_profiles(5, [s[0].shape[0] for s in shards],
                                      seed=seed)
    params = model.init(threefry.key(seed), dev)
    model_bytes = 4 * model.n_params
    trainer = LocalTrainer(model, lr=0.05, batch_size=64)
    workers = {i: SimWorker(i, x, y, trainer, p)
               for i, (p, (x, y)) in enumerate(zip(profiles, shards))}
    stats = {i: make_stats(p, t_onedata_server=5e-5, server_freq=2.4e9,
                           model_bytes=model_bytes)
             for i, p in enumerate(profiles)}
    # 3. aggregation server: selection policy + sync/async merge
    server = AggregationServer(params, stats, ServerConfig(
        policy=policy, mode=mode, epochs_per_round=4), impl=impl)
    # 4. the engine simulates wall-clock from the profiles while the
    #    workers really train on their shards
    test_i, test_l = make_classification_set("synmnist", 1024, seed=9)
    return FLSimulation(server, workers, test_i, test_l,
                        t_per_sample_ref=5e-5, model_bytes=model_bytes,
                        seed=seed)


def run(device="cuda", *, max_merges: int = 80, seed: int = 0) -> SimResult:
    return make_simulation(device, seed=seed).run_async(max_merges=max_merges)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    result = run(args.device)
    for r in result.records[::8]:
        print(f"t={r.time:7.1f}s  acc={r.acc:.3f}  merges={r.round}")
    print(f"\nbest accuracy {result.best_acc:.3f}; "
          f"time to 80%: {result.time_to_accuracy(0.8):.1f}s simulated")
    print(f"fed_agg kernel launches: {fed_agg_cuda.launches}")


if __name__ == "__main__":
    main()

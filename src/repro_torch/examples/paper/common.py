"""Shared harness for the paper-figure experiments (Tier-A event sim), port
of the JAX package's `benchmarks/common.py`.

A fleet follows the paper's Table III config: synMNIST configs train the
MLP, synCIFAR ones the CNN.  Initial params come from
`model.init(threefry.key(seed), device)`, which are the JAX harness's
`model.init(jax.random.key(seed))`; the timing draws and batch orders are
the JAX run's too, so a port run differs from it only in float rounding.
"""
from __future__ import annotations

import contextlib

import numpy as np

from repro_torch import threefry
from repro_torch.core.client import LocalTrainer, SimWorker
from repro_torch.core.cost_model import heterogeneous_profiles, make_stats
from repro_torch.core.events import FLSimulation
from repro_torch.core.server import AggregationServer, ServerConfig
from repro_torch.data.partition import paper_table3, partition_by_batches
from repro_torch.data.synthetic import make_classification_set
from repro_torch.models import build_model
from repro_torch.models.config import ModelConfig
from repro_torch.runtime import resolve_device

MLP = ModelConfig(name="bench-mlp", family="cnn", num_layers=0, d_model=96,
                  img_hw=28, img_c=1, n_classes=10, remat=False)
CNN_CIFAR = ModelConfig(name="bench-cnn", family="cnn", num_layers=2,
                        d_model=0, img_hw=32, img_c=3,
                        cnn_channels=(16, 32), n_classes=10, remat=False)

_DATA_CACHE: dict = {}


def dataset(kind: str, n: int, seed: int):
    key = (kind, n, seed)
    if key not in _DATA_CACHE:
        _DATA_CACHE[key] = make_classification_set(kind, n, seed=seed)
    return _DATA_CACHE[key]


def build_sim(*, table_config: int, policy: str, mode: str = "sync",
              seed: int = 0, epochs: int = 2, batch_size: int = 128,
              invert_speed_data: bool = False, rmin: float = 2.0,
              rmax: float = 4.0, random_k: int = 5,
              speed_spread: float = 4.0, device="cuda") -> FLSimulation:
    """Fleet per paper Table III config; MNIST-family -> MLP, CIFAR -> CNN.
    Configs 1 and 3 give some workers empty shards: they are never
    trained (the client returns the params it was sent)."""
    dev = resolve_device(device)
    kind, batches = paper_table3(table_config)
    n_workers = len(batches)
    imgs, labels = dataset(kind, 16384, seed)
    test_i, test_l = dataset(kind, 1024, seed + 99)
    shards = partition_by_batches(imgs, labels, batches,
                                  batch_size=batch_size, seed=seed)
    model = build_model(MLP if kind == "synmnist" else CNN_CIFAR)
    # trainer minibatch is fixed at 64; `batch_size` is the paper's shard
    # allocation unit (Tables III/IV count data in batches)
    trainer = LocalTrainer(model, lr=0.05 if kind == "synmnist" else 0.02,
                           batch_size=64)
    profiles = heterogeneous_profiles(
        n_workers, [s[0].shape[0] for s in shards], seed=seed,
        speed_spread=speed_spread)
    if invert_speed_data:
        # data-rich workers are SLOW (fig16 pathology setup)
        order = np.argsort([-p.n_data for p in profiles])
        speeds = sorted([p.speed_factor for p in profiles])
        for rank, i in enumerate(order):
            profiles[i].speed_factor = speed_spread - speeds[rank] + 1.0

    params = model.init(threefry.key(seed), dev)
    model_bytes = 4 * model.n_params
    workers, stats = {}, {}
    for i, (p, (xi, yi)) in enumerate(zip(profiles, shards)):
        workers[i] = SimWorker(i, xi, yi, trainer, p)
        stats[i] = make_stats(p, t_onedata_server=5e-5, server_freq=2.4e9,
                              model_bytes=model_bytes)
    srv = AggregationServer(
        params, stats,
        ServerConfig(policy=policy, mode=mode, epochs_per_round=epochs,
                     rmin_init=rmin, rmax_init=rmax, random_k=random_k),
        seed=seed)
    # t_per_sample calibrated so compute dominates messaging overheads,
    # matching the paper's CNN-on-VM regime (their rounds took minutes)
    return FLSimulation(srv, workers, test_i[:1024], test_l[:1024],
                        t_per_sample_ref=5e-4, model_bytes=model_bytes,
                        round_overhead=0.1, seed=seed)


def run(sim: FLSimulation, *, mode: str, rounds: int = 48,
        merges: int = 320, target: float = np.inf):
    if mode == "async":
        return sim.run_async(max_merges=merges, target_acc=target)
    return sim.run_sync(rounds=rounds, target_acc=target)


@contextlib.contextmanager
def recorded_results(simulation=FLSimulation):
    """Every SimResult that `simulation.run_sync` / `run_async` return
    inside the block, in order: the class's two methods are wrapped, and
    restored on exit.  `simulation` is any class with those methods."""
    out = []
    originals = {n: getattr(simulation, n) for n in ("run_sync",
                                                     "run_async")}

    def recording(fn):
        def run(self, *args, **kwargs):
            out.append(fn(self, *args, **kwargs))
            return out[-1]
        return run
    for name, fn in originals.items():
        setattr(simulation, name, recording(fn))
    try:
        yield out
    finally:
        for name, fn in originals.items():
            setattr(simulation, name, fn)


def emit_curve(name: str, result, stride: int = 1):
    for r in result.records[::stride]:
        print(f"curve,{name},{r.time:.2f},{r.acc:.4f},{r.n_selected}")


def dynamic_target(*results, frac: float = 0.95) -> float:
    """Common achievable accuracy target: frac x the WORST series' best."""
    return frac * min(r.best_acc for r in results)


def emit_tta(name: str, result, target: float):
    t = result.time_to_accuracy(target)
    print(f"tta,{name},{target},{t:.2f},{result.best_acc:.4f}")
    return t

"""Crash-safe resume on the port: a seeded server crash kills a run, a
fresh simulation resumes it from its checkpoint, and the two together must
give the uninterrupted run's SimRecord stream and final params exactly.

The fleet and faults are the JAX package's resume test's: 5 workers of 2
batches each training a 64-wide MLP on synMNIST (seed 11), 30 % Byzantine
workers (sign flips, x8 scaling), 10 % dropped and 10 % re-delivered
responses; the server dies in sync round 2 of 5, or at async merge 4 of 8.

  PYTHONPATH=src python -m repro_torch.examples.resume [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import tempfile
from pathlib import Path

import torch

from repro_torch import threefry
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.client import LocalTrainer, SimWorker
from repro_torch.core.cost_model import heterogeneous_profiles, make_stats
from repro_torch.core.events import FLSimulation, SimResult
from repro_torch.core.faults import FaultConfig, FaultPlan
from repro_torch.core.server import AggregationServer, ServerConfig
from repro_torch.data.partition import partition_by_batches
from repro_torch.data.synthetic import make_classification_set
from repro_torch.models import build_model
from repro_torch.models.config import ModelConfig
from repro_torch.runtime import resolve_device
from repro_torch.tree import leaves

MLP = ModelConfig(name="tiny-mlp", family="cnn", num_layers=0, d_model=64,
                  img_hw=28, img_c=1, n_classes=10, remat=False)
FAULTS = FaultConfig(byzantine_frac=0.3, attacks=("sign_flip", "scale"),
                     scale_factor=8.0, drop_frac=0.1, duplicate_frac=0.1,
                     seed=11)
CRASH_AT = {"sync": 2, "async": 4}      # round / merge the server dies in
RUN_LEN = {"sync": 5, "async": 8}       # rounds / merges of a run
SEED = 11


def make_sim(mode: str, *, faults=None, ckpt=None, device="cuda"
             ) -> FLSimulation:
    """The resume fleet; `faults` a FaultConfig or None, `ckpt` a
    CheckpointManager or None."""
    dev = resolve_device(device)
    imgs, labels = make_classification_set("synmnist", 4096, seed=1)
    test_i, test_l = make_classification_set("synmnist", 1024, seed=2)
    model = build_model(MLP)
    trainer = LocalTrainer(model, lr=0.05, batch_size=64)
    shards = partition_by_batches(imgs, labels, [2] * 5, batch_size=64,
                                  seed=SEED)
    profiles = heterogeneous_profiles(5, [s[0].shape[0] for s in shards],
                                      seed=SEED)
    model_bytes = 4 * model.n_params
    workers = {i: SimWorker(i, x, y, trainer, p)
               for i, (p, (x, y)) in enumerate(zip(profiles, shards))}
    stats = {i: make_stats(p, t_onedata_server=5e-5, server_freq=2.4e9,
                           model_bytes=model_bytes)
             for i, p in enumerate(profiles)}
    srv = AggregationServer(model.init(threefry.key(SEED), dev), stats,
                            ServerConfig(policy="all", mode=mode,
                                         epochs_per_round=2), seed=SEED)
    return FLSimulation(srv, workers, test_i[:512], test_l[:512],
                        t_per_sample_ref=5e-5, model_bytes=model_bytes,
                        seed=SEED,
                        faults=None if faults is None else FaultPlan(faults),
                        ckpt=ckpt)


def run(sim: FLSimulation, mode: str, **kw) -> SimResult:
    if mode == "sync":
        return sim.run_sync(RUN_LEN[mode], **kw)
    return sim.run_async(RUN_LEN[mode], **kw)


def crash_and_resume(mode: str, directory, device="cuda"
                     ) -> tuple[SimResult, SimResult, SimResult, int]:
    """-> (uninterrupted run, run killed at CRASH_AT[mode], the resumed
    rest from a fresh simulation, the merges the three made); checkpoints
    under directory/mode."""
    crashing = dataclasses.replace(FAULTS,
                                   server_crash_rounds=(CRASH_AT[mode],))
    ref = run(make_sim(mode, faults=FAULTS, device=device), mode)
    mgr = CheckpointManager(Path(directory) / mode)
    sim = make_sim(mode, faults=crashing, ckpt=mgr, device=device)
    killed = run(sim, mode)
    resumed = run(make_sim(mode, faults=crashing, ckpt=mgr, device=device),
                  mode, resume=True)
    # a run's last record carries its server's version, the merges it
    # made; the killed server's version also counts the merge of the round
    # it died in, and the resumed run starts from the killed run's last
    # record's version
    merges = ref.records[-1].version + sim.server.version + \
        resumed.records[-1].version - killed.records[-1].version
    return ref, killed, resumed, merges


def holds(ref: SimResult, killed: SimResult, resumed: SimResult) -> bool:
    """Killed, then resumed, equals the uninterrupted run: every record,
    and the final params bit for bit."""
    return (killed.crashed and not resumed.crashed and not ref.crashed
            and killed.records + resumed.records == ref.records
            and all(torch.equal(a, b) for a, b in zip(
                leaves(resumed.final_params), leaves(ref.final_params))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    ok = True
    with tempfile.TemporaryDirectory() as d:
        for mode in ("sync", "async"):
            ref, killed, resumed, _ = crash_and_resume(mode, d,
                                                       args.device)
            good = holds(ref, killed, resumed)
            ok &= good
            print(f"{mode}: killed after {len(killed.records)} records, "
                  f"resumed {len(resumed.records)}, uninterrupted "
                  f"{len(ref.records)}: "
                  f"{'identical' if good else 'DIFFERENT'}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())

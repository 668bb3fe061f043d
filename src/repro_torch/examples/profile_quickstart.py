"""Where the quickstart's time goes on the card.

Runs the quickstart (Alg. 2, async, 80 merges, seed 0) twice on CUDA: once
with each layer's host time taken between synchronisations (local training,
evaluation, the server's merge, the rest of the engine), once under
`torch.profiler` for the device's kernel time by name and its busy share.
With `--merge`, instead, one async merge of the quickstart's tree as the
server calls it (`aggregation.async_merge`, K = 2 over flight-cnn-mnist's
6 leaves): its time a Python call, and its device operations and
host-side CUDA calls under the profiler.  That part uses only what every
tree of the port has, so an older tree can be read with this script:

  PYTHONPATH=src python -m repro_torch.examples.profile_quickstart [--merge]
  PYTHONPATH=<older tree>/src python src/repro_torch/examples/profile_quickstart.py --merge
"""
from __future__ import annotations

import argparse
import collections
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import aggregation
from repro_torch.examples import quickstart
from repro_torch.tree import tree_map


def _timed(obj, name: str, bucket: dict, label: str):
    """Wrap obj.name so its host time, device work included, adds up."""
    fn = getattr(obj, name)

    def wrapped(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        bucket[label] += time.perf_counter() - t0
        return out
    setattr(obj, name, wrapped)


def layer_times(max_merges: int) -> dict[str, float]:
    sim = quickstart.make_simulation("cuda")
    trainer = next(iter(sim.workers.values())).trainer
    bucket: dict[str, float] = collections.defaultdict(float)
    _timed(trainer, "train_checked", bucket, "local training")
    _timed(trainer, "evaluate", bucket, "evaluation")
    _timed(sim.server, "async_fold", bucket, "merge (async_fold)")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.run_async(max_merges=max_merges)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    bucket["engine, selection, host"] = total - sum(bucket.values())
    bucket["total"] = total
    return dict(bucket)


def device_profile(max_merges: int):
    sim = quickstart.make_simulation("cuda")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.run_async(max_merges=max_merges)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return wall, sorted(kernels, key=lambda e: -e.self_device_time_total)


def merge_calls(n: int = 1000, repeats: int = 5):
    """One async merge of the quickstart's tree: its time a Python call
    (the median of `repeats` runs of n calls, one synchronise after each
    run), then under the profiler one call's device operations and the
    host's CUDA runtime calls by name."""
    server = quickstart.make_simulation("cuda").server.params
    worker = tree_map(lambda p: p + 0.01, server)
    for _ in range(20):
        aggregation.async_merge(server, worker, 0.3)
    torch.cuda.synchronize()
    runs = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(n):
            aggregation.async_merge(server, worker, 0.3)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) / n * 1e6)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        aggregation.async_merge(server, worker, 0.3)
        torch.cuda.synchronize()
    events = prof.key_averages()
    device = {e.key: e.count for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA}
    runtime = {e.key: e.count for e in events
               if e.device_type == torch.autograd.DeviceType.CPU
               and e.key.startswith("cuda")}
    runs.sort()
    print(f"async_merge on the quickstart's tree: "
          f"{runs[len(runs) // 2]:.2f} us a Python call (median of "
          f"{repeats} runs of {n}: {[round(r, 2) for r in runs]}); device "
          f"operations a merge {sum(device.values())}: {device}; host CUDA "
          f"calls {runtime}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--merge", action="store_true",
                    help="only the async merge's call time and operations")
    args = ap.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    if args.merge:      # its own process: a second profiler run in one
        merge_calls()   # process may record no device activity
        return
    quickstart.run("cuda", max_merges=4)          # warm-up: build, cuDNN
    times = layer_times(80)
    total = times.pop("total")
    print(f"quickstart, 80 merges: {total:.3f} s wall (layers timed "
          "between synchronisations)")
    for label, t in sorted(times.items(), key=lambda kv: -kv[1]):
        print(f"  {label:26s} {t:8.3f} s  {t / total:6.1%}")
    wall, kernels = device_profile(80)
    busy_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in kernels)
    print(f"under torch.profiler: {wall:.3f} s wall, {launches} kernel "
          f"launches, device busy {busy_us / 1e3:.1f} ms "
          f"({busy_us / 1e6 / wall:.2%} of wall)")
    for e in kernels[:12]:
        print(f"  {e.self_device_time_total / 1e3:9.2f} ms {e.count:7d}x  "
              f"{e.key[:90]}")


if __name__ == "__main__":
    main()

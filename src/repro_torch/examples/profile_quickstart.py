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
import contextlib
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import aggregation
from repro_torch.core.client import LocalTrainer
from repro_torch.core.server import AggregationServer
from repro_torch.examples import quickstart
from repro_torch.tree import tree_map


def timed(cls, name: str, bucket: dict, label: str):
    """Wrap cls.name so its host time, device work included, adds up in
    bucket[label] for every instance."""
    fn = getattr(cls, name)

    def wrapped(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        bucket[label] += time.perf_counter() - t0
        return out
    setattr(cls, name, wrapped)


LAYERS = ((LocalTrainer, "train_checked", "local training"),
          (LocalTrainer, "train_cohort_checked", "local training"),
          (LocalTrainer, "evaluate", "evaluation"),
          (AggregationServer, "sync_aggregate", "merge"),
          (AggregationServer, "async_fold", "merge"))


@contextlib.contextmanager
def layer_times():
    """Time the layers of every simulation run inside the block -> a
    bucket of seconds by label; "total" and the engine's rest are filled
    in on exit."""
    bucket: dict[str, float] = collections.defaultdict(float)
    saved = [(cls, name, cls.__dict__[name]) for cls, name, _ in LAYERS]
    for cls, name, label in LAYERS:
        timed(cls, name, bucket, label)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        yield bucket
    finally:
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        for cls, name, fn in saved:
            setattr(cls, name, fn)
        bucket["engine, selection, host"] = total - sum(bucket.values())
        bucket["total"] = total


def report(label: str, bucket: dict[str, float]):
    total = bucket["total"]
    parts = ", ".join(f"{k} {v:.3f} s ({v / total:.1%})" for k, v in
                      sorted(bucket.items(), key=lambda kv: -kv[1])
                      if k != "total")
    print(f"{label}: {total:.3f} s wall; {parts}", flush=True)


def device_profile(run):
    """run() under torch.profiler -> (wall s, CUDA kernels by device time)."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
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
    sim = quickstart.make_simulation("cuda")
    with layer_times() as bucket:
        sim.run_async(max_merges=80)
    report("quickstart, 80 merges (layers timed between synchronisations)",
           bucket)
    report_kernels(*device_profile(
        lambda: quickstart.make_simulation("cuda").run_async(max_merges=80)))


def report_kernels(wall: float, kernels, top: int = 12):
    busy_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in kernels)
    print(f"under torch.profiler: {wall:.3f} s wall, {launches} kernel "
          f"launches, device busy {busy_us / 1e3:.1f} ms "
          f"({busy_us / 1e6 / wall:.2%} of wall)")
    for e in kernels[:top]:
        print(f"  {e.self_device_time_total / 1e3:9.2f} ms {e.count:7d}x  "
              f"{e.key[:90]}")


if __name__ == "__main__":
    main()

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


LAYERS = ((LocalTrainer, "train_checked", "local training"),
          (LocalTrainer, "train_cohort_checked", "local training"),
          (LocalTrainer, "evaluate", "evaluation"),
          (AggregationServer, "sync_aggregate", "merge"),
          (AggregationServer, "async_fold", "merge"))


@contextlib.contextmanager
def layer_times(layers=LAYERS, device="cuda", *, ranges=False):
    """Time each (owner, attribute, label) of `layers` -- a class's method
    or a module's function -- in every run inside the block, between
    synchronisations -> a bucket of seconds by label.  A layer's time is
    its self time: layers nested inside it are taken out.  "engine" (the
    rest: the engine's own code, selection, host) and "total" are filled
    in on exit.  With ranges=True each layer runs inside a torch.profiler
    range of its label instead, with no synchronisation, and the bucket
    stays empty: `range_split` reads the device time by range from a
    `profiled` run inside the block."""
    # imported here: --merge reads older trees, whose runtime lacks it
    from repro_torch.runtime import synchronize
    bucket: dict[str, float] = collections.defaultdict(float)
    inner = [0.0]           # time of the timed layers inside the current one

    def timed(fn, label):
        def wrapped(*args, **kwargs):
            synchronize(device)
            outer, inner[0] = inner[0], 0.0
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                synchronize(device)
                spent = time.perf_counter() - t0
                bucket[label] += spent - inner[0]
                inner[0] = outer + spent
        return wrapped

    def ranged(fn, label):
        def wrapped(*args, **kwargs):
            with torch.profiler.record_function(label):
                return fn(*args, **kwargs)
        return wrapped

    wrap = ranged if ranges else timed
    saved = [(owner, name, vars(owner)[name]) for owner, name, _ in layers]
    for owner, name, label in layers:
        setattr(owner, name, wrap(getattr(owner, name), label))
    synchronize(device)
    t0 = time.perf_counter()
    try:
        yield bucket
    finally:
        synchronize(device)
        total = time.perf_counter() - t0
        for owner, name, fn in saved:
            setattr(owner, name, fn)
        if not ranges:
            bucket["engine"] = total - sum(bucket.values())
            bucket["total"] = total


def report(label: str, bucket: dict[str, float]):
    total = bucket["total"]
    parts = ", ".join(f"{k} {v:.3f} s ({v / total:.1%})" for k, v in
                      sorted(bucket.items(), key=lambda kv: -kv[1])
                      if k != "total")
    print(f"{label}: {total:.3f} s wall; {parts}", flush=True)


def profiled(run):
    """run() under torch.profiler, from a synchronised start to a
    synchronised end -> (wall s, the profiler)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return wall, prof


def device_profile(run):
    """run() under torch.profiler -> (wall s, CUDA kernels by device time)."""
    wall, prof = profiled(run)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return wall, sorted(kernels, key=lambda e: -e.self_device_time_total)


def range_split(prof, labels, other=lambda event: "rest") -> dict:
    """Device seconds of a profiled run by range: each operation's own
    kernels go to the innermost range of `labels` around it (layer_times
    with ranges=True opens them), else to other(operation)'s label."""
    split = collections.defaultdict(float)
    for e in prof.events():
        t = e.self_device_time_total / 1e6
        if t <= 0 or e.device_type != torch.autograd.DeviceType.CPU:
            continue
        label, parent = None, e
        while parent is not None and label is None:
            if parent.name in labels:
                label = parent.name
            parent = parent.cpu_parent
        split[label if label is not None else other(e)] += t
    return split


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

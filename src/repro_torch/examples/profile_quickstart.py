"""Where the quickstart's time goes on the card.

Runs the quickstart (Alg. 2, async, 80 merges, seed 0) twice on CUDA: once
with each layer's host time taken between synchronisations (local training,
evaluation, the server's merge, the rest of the engine), once under
`torch.profiler` for the device's kernel time by name and its busy share.

  PYTHONPATH=src python -m repro_torch.examples.profile_quickstart
"""
from __future__ import annotations

import collections
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.examples import quickstart


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


def main():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
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

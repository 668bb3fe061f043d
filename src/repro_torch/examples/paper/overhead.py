"""Framework-overhead microbenchmarks -- the paper's 'lightweight' claim;
port of the JAX package's `benchmarks/overhead.py`.

Emits `name,us_per_call,derived` rows: worker selection over large fleets
(host code), aggregation of a real-size model (one grouped fed_agg launch
on the card), fed_agg alone, warehouse pointer ops (on the card also with
the wait for the copies they enqueue), int8 compression (the quant8
kernel).  A timed aggregation or compression call on the card ends
in `torch.cuda.synchronize`, where the reference's ends in
`block_until_ready`.  On the CPU the kernels'
plain versions run, and the kernel row says so.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core import aggregation, compression, selection
from repro_torch.core.cost_model import WorkerStats
from repro_torch.core.warehouse import DataWarehouse
from repro_torch.kernels.fed_agg.ops import fed_agg
from repro_torch.runtime import resolve_device


def _time(fn, n=20, warmup=2):
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n * 1e6  # us


def _synced(dev: torch.device, fn):
    """fn, then a wait for the card's queue to drain (a no-op on the CPU)."""
    if dev.type != "cuda":
        return fn

    def call():
        out = fn()
        torch.cuda.synchronize(dev)
        return out
    return call


def bench_selection(n_workers: int, seed: int):
    rng = np.random.default_rng(seed)
    stats = {i: WorkerStats(i, float(rng.uniform(1, 10)),
                            float(rng.uniform(0.1, 1)),
                            int(rng.integers(1, 100)))
             for i in range(n_workers)}
    st1 = selection.RMinRMaxState(2, 4)
    st2 = selection.TimeBasedState(T=20.0, r=2)
    us1 = _time(lambda: selection.rmin_rmax_select(stats, st1))
    us2 = _time(lambda: selection.time_based_select(stats, st2))
    print(f"selection.rmin_rmax.{n_workers}w,{us1:.1f},us_per_round")
    print(f"selection.time_based.{n_workers}w,{us2:.1f},us_per_round")


def bench_aggregation(n_params: int, k: int, dev: torch.device):
    trees = [{"w": torch.ones(n_params, device=dev) * i} for i in range(k)]
    w = np.full(k, 1.0 / k)
    fn = _synced(dev, lambda: aggregation.weighted_average(trees, w))
    fn()
    us = _time(fn, n=10)
    gbps = n_params * 4 * k / (us / 1e6) / 1e9
    print(f"aggregation.fedavg.{k}x{n_params//1000}k,{us:.1f},{gbps:.2f}GBps")


def bench_kernel_agg(n_params: int, k: int, dev: torch.device):
    x = torch.ones(k, n_params, device=dev)
    w = np.full(k, 1.0 / k)
    fn = _synced(dev, lambda: fed_agg(x, w))
    fn()
    us = _time(fn, n=10)
    route = "cuda" if dev.type == "cuda" else "plain"
    print(f"kernel.fed_agg.{k}x{n_params//1000}k,{us:.1f},{route}")


def bench_warehouse(dev: torch.device):
    """Pointer ops on a 1 MB tree, each row's time the host's call, as the
    reference times it.  The port's memory store copies the tree on `put`
    and on `get` (the reference's copies nothing), so where the store is
    on the card the row's derived field adds `synced_us`, the call and the
    wait for the card's queue to drain, and for `put` `reused_us`, that
    into a store which deletes the previous uid first and so never grows."""
    wh = DataWarehouse(device=dev)
    tree = {"w": torch.ones(250_000, device=dev)}
    ptr = wh.put(tree)
    calls = {"put": (lambda: wh.put(tree), 20, "pointer_store"),
             "get": (lambda: wh.get(ptr.uid), 50, "pointer_fetch"),
             "credential_fetch": (lambda: wh.fetch(wh.issue_credential(
                 ptr.uid)), 50, "one_time_token")}
    last = [wh.put(tree)]

    def replace():
        wh.delete(last[0].uid)
        last[0] = wh.put(tree)
    for name, (fn, n, derived) in calls.items():
        us = _time(fn, n=n)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)   # the queued copies end here
            derived += f";synced_us={_time(_synced(dev, fn), n=n):.1f}"
            if name == "put":
                reused = _time(_synced(dev, replace), n=n)
                derived += f";reused_us={reused:.1f}"
        print(f"warehouse.{name}.1MB,{us:.1f},{derived}")


def bench_compression(dev: torch.device, seed: int):
    x = {"w": torch.as_tensor(np.random.default_rng(seed).normal(
        size=(1 << 20,)), dtype=torch.float32, device=dev)}
    fn = _synced(dev, lambda: compression.quantize_blockwise(x["w"],
                                                             block=256))
    fn()
    us = _time(fn, n=10)
    ratio = compression.compressed_bytes(x) / (x["w"].numel() * 4)
    print(f"compression.int8.4MB,{us:.1f},ratio={ratio:.3f}")


def main(seed=0, device="cuda"):
    dev = resolve_device(device)
    print("name,us_per_call,derived")
    for n in (100, 1000, 10000):
        bench_selection(n, seed)
    bench_aggregation(1 << 20, 10, dev)
    bench_kernel_agg(1 << 18, 8, dev)
    bench_warehouse(dev)
    bench_compression(dev, seed)


if __name__ == "__main__":
    main()

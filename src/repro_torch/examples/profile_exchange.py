"""Where the island exchange's time goes on the card.

For one P = 8 exchange of the fl_exchange workload in each mode (flat),
and q8 through 2 fog cells: the time per exchange on the CUDA event clock,
then 20 exchanges under `torch.profiler` for the kernels launched per
exchange, the device's busy time per exchange and its busy share, and the
kernel time by name.

  PYTHONPATH=src python -m repro_torch.examples.profile_exchange
"""
from __future__ import annotations

import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.examples import fl_exchange
from repro_torch.runtime import resolve_device

P = 8
EXCHANGES = 20


def device_profile(fn, n: int):
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return wall, sorted(kernels, key=lambda e: -e.self_device_time_total)


def main():
    dev = resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    stacked, base = fl_exchange.make_tree(P, device=dev)
    for mode, fog_cells in [(m, 1) for m in fl_exchange.MODES] + [("q8", 2)]:
        ex = fl_exchange.exchange_fn(P, mode, fog_cells=fog_cells,
                                     device=dev)
        fn = lambda: ex(stacked, base)
        ms = fl_exchange.time_ms(fn, dev, EXCHANGES)
        wall, kernels = device_profile(fn, EXCHANGES)
        busy_us = sum(e.self_device_time_total for e in kernels)
        launches = sum(e.count for e in kernels)
        tier = "flat" if fog_cells == 1 else f"{fog_cells} fog cells"
        print(f"P={P} {mode} {tier}: {ms:.4f} ms per exchange (CUDA "
              f"events); under torch.profiler {launches / EXCHANGES:.0f} "
              f"kernels and {busy_us / EXCHANGES:.1f} us device busy per "
              f"exchange, {busy_us / 1e6 / wall:.2%} of wall")
        for e in kernels[:8]:
            print(f"  {e.self_device_time_total / EXCHANGES:9.2f} us "
                  f"{e.count // EXCHANGES:4d}x  {e.key[:90]}")


if __name__ == "__main__":
    main()

"""Where the island exchange's time goes on the card.

For one P = 8 exchange of the fl_exchange workload in each mode (flat),
and q8 through 2 fog cells: the time per exchange on the CUDA event clock
(the median of 5 runs of 20 exchanges, with the other four beside it: the
exchange is host-bound and the host's clock is shared), then 20 exchanges
under `torch.profiler` for the kernels launched per exchange, the device's
busy time per exchange and its busy share, and the kernel time by name.
The script uses only fl_exchange's entry points, so it can time an older
tree of the port too (PYTHONPATH=<tree>/src python <this file>).  With
--quick it times only the q8 exchange, flat and through 2 fog cells, with
no profiler, and prints the two medians as a JSON last line (what
examples/exchange_ab.py reads).

  PYTHONPATH=src python -m repro_torch.examples.profile_exchange [--quick]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.examples import fl_exchange
from repro_torch.runtime import resolve_device

P = 8
EXCHANGES = 20
REPEATS = 5


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
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="q8 flat and two-tier only, no profiler")
    quick = ap.parse_args().quick
    dev = resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    stacked, base = fl_exchange.make_tree(P, device=dev)
    cells = [("q8", 1), ("q8", 2)] if quick else \
        [(m, 1) for m in fl_exchange.MODES] + [("q8", 2)]
    medians = {}
    for mode, fog_cells in cells:
        ex = fl_exchange.exchange_fn(P, mode, fog_cells=fog_cells,
                                     device=dev)
        fn = lambda: ex(stacked, base)
        runs = sorted(fl_exchange.time_ms(fn, dev, EXCHANGES)
                      for _ in range(REPEATS))
        ms = runs[REPEATS // 2]
        tier = "flat" if fog_cells == 1 else f"{fog_cells} fog cells"
        medians[f"{mode} {tier}"] = ms
        if quick:
            print(f"P={P} {mode} {tier}: {ms:.4f} ms per exchange (CUDA "
                  f"events, median of {[round(r, 4) for r in runs]})")
            continue
        wall, kernels = device_profile(fn, EXCHANGES)
        busy_us = sum(e.self_device_time_total for e in kernels)
        launches = sum(e.count for e in kernels)
        print(f"P={P} {mode} {tier}: {ms:.4f} ms per exchange (CUDA "
              f"events, median of {[round(r, 4) for r in runs]}); under "
              f"torch.profiler {launches / EXCHANGES:.0f} "
              f"kernels and {busy_us / EXCHANGES:.1f} us device busy per "
              f"exchange, {busy_us / 1e6 / wall:.2%} of wall")
        for e in kernels[:8]:
            print(f"  {e.self_device_time_total / EXCHANGES:9.2f} us "
                  f"{e.count // EXCHANGES:4d}x  {e.key[:90]}")
    if quick:
        print(json.dumps(medians))


if __name__ == "__main__":
    main()

"""Where the LM serving path's time goes on the card.

One arch at full width (params drawn on the card), the serve entry point's
work at its chip settings: one prefill of B x 2,048 tokens and decode steps
at batch B.  A warm-up prefill and step first; then the prefill and 8
decode steps are timed on the host clock (ending in a synchronise) and run
again under `torch.profiler` for the device's busy time, its busy share of
the wall and the kernel time by name, with the shares of the port's own
kernels (flash_attention, linrec).

  PYTHONPATH=src python -m repro_torch.examples.profile_serve   # granite-20b
  PYTHONPATH=src python -m repro_torch.examples.profile_serve \
      --arch falcon-mamba-7b --batch 4
  PYTHONPATH=src python -m repro_torch.examples.profile_serve \
      --arch recurrentgemma-9b --batch 2
"""
from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import build_model
from repro_torch.models.param import init_params_on_device
from repro_torch.runtime import resolve_device

T, STEPS = 2048, 8
#: the port's kernels, by a substring of their CUDA function names
OWN_KERNELS = {"flash_attention": "flash_fwd", "linrec": "linrec_"}


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def profiled(fn):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    return wall, kernels


def report(name, wall, kernels, per: int):
    busy = sum(e.self_device_time_total for e in kernels) / 1e6   # s
    launches = sum(e.count for e in kernels)
    own = []
    for kname, key in OWN_KERNELS.items():
        t = sum(e.self_device_time_total for e in kernels
                if key in e.key) / 1e6
        n = sum(e.count for e in kernels if key in e.key)
        own.append(f"{kname} {t * 1e3 / per:.2f} ms in {n / per:g} launches "
                   f"({t / busy:.2%} of busy)")
    print(f"{name} under torch.profiler: {wall * 1e3 / per:.2f} ms wall, "
          f"device busy {busy * 1e3 / per:.2f} ms ({busy / wall:.2%} of "
          f"wall, idle {1 - busy / wall:.2%}), {launches / per:.0f} kernels;"
          f" {'; '.join(own)}")
    for e in kernels[:10]:
        print(f"  {e.self_device_time_total / 1e3 / per:10.3f} ms "
              f"{e.count // per:5d}x  {e.key[:90]}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-20b")
    ap.add_argument("--batch", type=int, default=8)
    args = ap.parse_args(argv)
    arch, B = args.arch, args.batch
    dev = resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    model = build_model(get_config(arch))
    params = init_params_on_device(0, model.param_defs(), dev)
    prefill, decode = make_prefill_step(model), make_decode_step(model)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, model.cfg.vocab_size, (B, T)).astype(np.int32), device=dev)
    state = {}

    def run_prefill():
        state["nxt"], state["cache"] = prefill(params, {"tokens": tokens})

    def run_decode():
        for i in range(STEPS):
            state["nxt"], state["cache"] = decode(params, {
                "tokens": state["nxt"][:, None],
                "positions": torch.full((B, 1), T + i, dtype=torch.int32,
                                        device=dev)}, state["cache"])

    run_prefill()
    run_decode()                                   # warm-up
    _, t_pre = timed(run_prefill)
    _, t_dec = timed(run_decode)
    print(f"{arch} full width ({model.n_params / 1e9:.2f} B params, bf16): "
          f"prefill {B}x{T} {t_pre * 1e3:.1f} ms ({B * T / t_pre:.0f} "
          f"tok/s), decode {t_dec * 1e3 / STEPS:.2f} ms/step "
          f"({B * STEPS / t_dec:.0f} tok/s), warm")
    report(f"prefill {B}x{T}", *profiled(run_prefill), 1)
    run_prefill()
    report(f"decode step, batch {B}", *profiled(run_decode), STEPS)


if __name__ == "__main__":
    main()

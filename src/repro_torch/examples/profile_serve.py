"""Where the dense-LM serving path's time goes on the card.

granite-20b at full width (params drawn on the card), the serve entry
point's work at its chip settings: one prefill of 8 x 2,048 tokens and
decode steps at batch 8.  A warm-up prefill and step first; then the
prefill and 8 decode steps are timed on the host clock (ending in a
synchronise) and run again under `torch.profiler` for the device's busy
time, its busy share of the wall and the kernel time by name, with the
flash_attention kernel's share.

  PYTHONPATH=src python -m repro_torch.examples.profile_serve
"""
from __future__ import annotations

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

ARCH, B, T, STEPS = "granite-20b", 8, 2048, 8


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
    flash = sum(e.self_device_time_total for e in kernels
                if "flash_fwd" in e.key) / 1e6
    launches = sum(e.count for e in kernels)
    print(f"{name} under torch.profiler: {wall * 1e3 / per:.2f} ms wall, "
          f"device busy {busy * 1e3 / per:.2f} ms ({busy / wall:.2%} of "
          f"wall, idle {1 - busy / wall:.2%}), {launches / per:.0f} kernels,"
          f" flash_attention {flash * 1e3 / per:.2f} ms ({flash / busy:.2%} "
          "of busy)")
    for e in kernels[:10]:
        print(f"  {e.self_device_time_total / 1e3 / per:10.3f} ms "
              f"{e.count // per:5d}x  {e.key[:90]}")


def main():
    dev = resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    model = build_model(get_config(ARCH))
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
    print(f"{ARCH} full width ({model.n_params / 1e9:.2f} B params, bf16): "
          f"prefill {B}x{T} {t_pre * 1e3:.1f} ms ({B * T / t_pre:.0f} "
          f"tok/s), decode {t_dec * 1e3 / STEPS:.2f} ms/step "
          f"({B * STEPS / t_dec:.0f} tok/s), warm")
    report(f"prefill {B}x{T}", *profiled(run_prefill), 1)
    run_prefill()
    report(f"decode step, batch {B}", *profiled(run_decode), STEPS)


if __name__ == "__main__":
    main()

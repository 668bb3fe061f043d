"""Where the LM serving path's time goes on the card.

One arch at full width (params drawn on the card), the serve entry point's
work at its chip settings: one prefill of B x 2,048 positions (the batch
of `serve.make_batch`: tokens, and phi-3-vision's patch embeddings or
seamless-m4t's frames) and decode steps at batch B.  A warm-up prefill
and step first; then the prefill and 8 decode steps are timed on the
host clock (ending in a synchronise) and run again under
`torch.profiler` for the device's busy time, its busy share of the wall
and the kernel time by name, with the shares of the port's own kernels
(flash_attention, linrec).

  PYTHONPATH=src python -m repro_torch.examples.profile_serve   # granite-20b
  PYTHONPATH=src python -m repro_torch.examples.profile_serve \
      --arch falcon-mamba-7b --batch 4
  PYTHONPATH=src python -m repro_torch.examples.profile_serve \
      --arch recurrentgemma-9b --batch 2
  PYTHONPATH=src python -m repro_torch.examples.profile_serve \
      --arch seamless-m4t-large-v2
  PYTHONPATH=src python -m repro_torch.examples.profile_serve --paged

`--paged` (granite-20b) profiles PagedServeLoop at `serve.py --paged
--batch 8 --prompt-len 512 --gen 32`'s pool: one admission's prefill
chunks (64 tokens each, one sequence) and warm decode ticks of all B
slots, each split by device time into the paged gather and write, the
attention, the GEMMs (cuBLAS matmuls outside attention) and the rest, and
the host (the wall's idle share).  Only a warm run is measured.
"""
from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.examples.profile_quickstart import (device_profile,
                                                     layer_times, profiled,
                                                     range_split)
from repro_torch.launch.serve import make_batch
from repro_torch.launch.serve_loop import PagedServeLoop, Request
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import build_model
from repro_torch.models import layers
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


#: the paged path's layers, each under a profiler range of its label
PAGED_LAYERS = ((layers, "paged_gather_kv", "gather"),
                (layers, "paged_kv_write", "write"),
                (layers, "paged_chunk_attention", "attention"),
                (layers, "decode_attention", "attention"))
GEMM_OPS = ("aten::mm", "aten::bmm", "aten::addmm")
PAGED_PROMPT, PAGED_GEN, PAGED_BLOCK = 512, 32, 16
PAGED_TICKS = 8


def paged_report(name, run, per: int):
    """run() warm under torch.profiler with the paged layers in ranges;
    print its wall, device busy share and device time by layer (outside
    the layers: a cuBLAS matmul is "GEMMs", else "rest"), per `per`."""
    with layer_times(PAGED_LAYERS, ranges=True):
        wall, prof = profiled(run)
    found = range_split(prof, {label for *_, label in PAGED_LAYERS},
                        lambda e: "GEMMs" if e.name in GEMM_OPS else "rest")
    split = {k: found.get(k, 0.0)
             for k in ("gather", "write", "attention", "GEMMs", "rest")}
    busy = sum(split.values())
    parts = ", ".join(f"{k} {v * 1e3 / per:.3f} ms ({v / wall:.2%})"
                      for k, v in split.items())
    print(f"{name} under torch.profiler: {wall * 1e3 / per:.2f} ms wall, "
          f"device busy {busy * 1e3 / per:.2f} ms ({busy / wall:.2%} of "
          f"wall); {parts}; host (idle) {(wall - busy) * 1e3 / per:.2f} ms "
          f"({1 - busy / wall:.2%})", flush=True)
    return {"wall_ms": wall * 1e3 / per, "busy_ms": busy * 1e3 / per,
            "busy_share": busy / wall,
            "split_ms": {k: v * 1e3 / per for k, v in split.items()}}


def profile_paged(model, params, B: int) -> dict:
    """A warm admission's prefill chunks and warm decode ticks of
    PagedServeLoop at serve.py --paged's pool for B slots."""
    bs, T = PAGED_BLOCK, PAGED_PROMPT
    nb = -(-(B * (T + PAGED_GEN) + bs) // bs)
    loop = PagedServeLoop(model, params, max_batch=B, num_blocks=nb,
                          block_size=bs, chunk=max(4 * bs, 32))
    rng = np.random.default_rng(0)
    for i in range(B):
        loop.submit(Request(rid=i, prompt=rng.integers(
            0, model.cfg.vocab_size, T).astype(np.int32),
            max_new=PAGED_GEN))
    loop.queue, rest = loop.queue[:1], loop.queue[1:]
    loop._admit()                        # warm-up admission
    loop.queue, rest = rest[:1], rest[1:]
    chunks = loop.chunk_steps
    out = {"chunk": paged_report(
        f"paged prefill chunk ({loop.chunk} tokens, 1 sequence)",
        loop._admit, T // loop.chunk)}
    if loop.chunk_steps - chunks != T // loop.chunk:
        raise RuntimeError(f"profiled {loop.chunk_steps - chunks} chunk "
                           f"steps, expected {T // loop.chunk}")
    loop.queue = rest
    loop._admit()
    for _ in range(3):                   # warm decode ticks
        loop.tick()
    out["decode"] = paged_report(
        f"paged decode tick, batch {B}, {T}+ positions",
        lambda: [loop.tick() for _ in range(PAGED_TICKS)], PAGED_TICKS)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-20b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--paged", action="store_true",
                    help="profile PagedServeLoop's chunk step and decode "
                         "tick instead")
    args = ap.parse_args(argv)
    arch, B = args.arch, args.batch
    dev = resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    model = build_model(get_config(arch))
    params = init_params_on_device(0, model.param_defs(), dev)
    if args.paged:
        return profile_paged(model, params, B)
    prefill, decode = make_prefill_step(model), make_decode_step(model)
    batch = make_batch(model.cfg, np.random.default_rng(0), B, T, dev)
    state = {}

    def run_prefill():
        state["nxt"], state["cache"] = prefill(params, batch)

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
    report(f"prefill {B}x{T}", *device_profile(run_prefill), 1)
    run_prefill()
    report(f"decode step, batch {B}", *device_profile(run_decode), STEPS)


if __name__ == "__main__":
    main()

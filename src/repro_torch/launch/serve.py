"""Batched serving launcher: prefill a batch of prompts, decode greedily.
Port of the fixed-batch path of `repro.launch.serve`.

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --smoke
  PYTHONPATH=src python -m repro_torch.launch.serve --full \\
      --batch 8 --prompt-len 2048 --gen 32          # granite-20b on a card
  PYTHONPATH=src python -m repro_torch.launch.serve --full \\
      --arch falcon-mamba-7b --batch 4 --prompt-len 2048 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --full \\
      --arch recurrentgemma-9b --batch 2 --prompt-len 2048 --gen 32

`--smoke` (the default) serves the arch's small config with the
reference's Threefry-drawn params; `--full` serves the published width
with params drawn on the device (`init_params_on_device`; not the JAX
package's numbers).  Prefill attention runs on the flash_attention kernel
(one launch per attention layer), the SSM and RG-LRU scans on the linrec
kernel (one launch per recurrent layer in prefill and in each decode
step); the script prints the prefill and decode times and rates, the
launches of each kernel in the prefill and per decode step, and on a card
the peak device memory.  The reference's weight-layout policy
(`--layout`, `pick_layout`) belongs to the planning layer; this launcher
prints the cache spec it serves with in its place.  `--paged` waits for
the paged slice.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import threefry
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.linrec.kernel import linrec_cuda
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import build_model
from repro_torch.models.cache import CacheSpec
from repro_torch.models.param import init_params_on_device
from repro_torch.runtime import resolve_device


#: the kernels a serve step can launch, by name
KERNELS = {"flash_attention": flash_attention_cuda, "linrec": linrec_cuda}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def _since(before: dict) -> dict:
    return {name: n - before[name] for name, n in _counts().items()}


def _show(counts: dict, per: int = 1) -> str:
    return ", ".join(f"{name} {n / per:g}" for name, n in counts.items())


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-20b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cache", default="auto",
                    help="KV-cache spec 'layout[:shards]/dtype' (e.g. "
                         "ring:4/int8, head/bf16); 'auto' keeps the "
                         "config's (models/cache.py)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.cache != "auto":
        cfg = dataclasses.replace(cfg,
                                  cache_spec=CacheSpec.parse(args.cache).name)
    model = build_model(cfg)
    t0 = time.perf_counter()
    if args.smoke:
        params = model.init(threefry.key(args.seed), device)
    else:
        params = init_params_on_device(args.seed, model.param_defs(), device)
    _sync(device)
    t_init = time.perf_counter() - t0
    cache_kind = CacheSpec.parse(cfg.cache_spec).name \
        if model.supports_cache_spec else f"{cfg.family} state"
    print(f"[serve] {cfg.name}: {model.n_params / 1e9:.2f} B params on "
          f"{device} (drawn in {t_init:.1f} s), cache {cache_kind}")

    prefill = make_prefill_step(model)
    decode = make_decode_step(model)
    rng = np.random.default_rng(args.seed)
    B, T = args.batch, args.prompt_len
    batch = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32),
        device=device)}

    before = _counts()
    t0 = time.perf_counter()
    nxt, cache = prefill(params, batch)
    _sync(device)
    t_prefill = time.perf_counter() - t0
    pre_launches = _since(before)
    print(f"[serve] prefill {B}x{T}: {t_prefill * 1e3:.1f}ms "
          f"({B * T / t_prefill:.0f} tok/s); kernel launches "
          f"{_show(pre_launches)}")

    out = [nxt.cpu().numpy()]
    before = _counts()
    t0 = time.perf_counter()
    for i in range(args.gen - 1):
        nxt, cache = decode(params, {
            "tokens": nxt[:, None],
            "positions": torch.full((B, 1), T + i, dtype=torch.int32,
                                    device=device)}, cache)
        out.append(nxt.cpu().numpy())
    _sync(device)
    t_dec = time.perf_counter() - t0
    dec_launches = _since(before)
    steps = max(args.gen - 1, 1)
    toks = np.stack(out, axis=1)
    print(f"[serve] decode {args.gen} steps: {t_dec * 1e3:.1f}ms "
          f"({t_dec * 1e3 / steps:.2f} ms/step, "
          f"{B * (args.gen - 1) / max(t_dec, 1e-9):.0f} tok/s); kernel "
          f"launches per step {_show(dec_launches, steps)}")
    peak = None
    if device.type == "cuda":
        peak = torch.cuda.max_memory_allocated(device) / 1e9
        print(f"[serve] peak device memory {peak:.2f} GB")
    print(f"[serve] sample generations (first 12 ids): "
          f"{toks[:, :12].tolist()}")
    return {"model": model, "params": params, "tokens": toks,
            "prefill_s": t_prefill,
            "decode_s": t_dec, "decode_steps": args.gen - 1,
            "launches": {"prefill": pre_launches, "decode": dec_launches},
            "peak_gb": peak, "init_s": t_init}


if __name__ == "__main__":
    main()

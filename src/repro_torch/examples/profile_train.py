"""Where a train step's time goes on the card.

qwen1.5-4b at full width (params drawn on the card), `launch/train.py`'s
step at its chip settings: 4 x 1,024 tokens, grad_accum 4, remat on,
adamw with clip 1.0.  A warm-up step first; then one step on the host
clock (ending in a synchronise), one with each part timed between
synchronisations (the forward and loss of each microbatch, its backward,
the gradient norm, the optimizer's in-place update; the rest is the
accumulation and the step's own Python), and one under `torch.profiler`
for the device's busy time, its share of the wall and the kernel time by
name.  `--layers N` cuts the depth.

  PYTHONPATH=src python -m repro_torch.examples.profile_train
  PYTHONPATH=src python -m repro_torch.examples.profile_train --device cpu \
      --smoke --batch 2 --seq 32
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import time

import torch

from repro_torch import threefry
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.synthetic import batch_token_stream, make_token_stream
from repro_torch.examples.profile_quickstart import device_profile
from repro_torch.launch import steps
from repro_torch.models import build_model
from repro_torch.models.param import init_params_on_device
from repro_torch.optim import adamw
from repro_torch.runtime import card_label, resolve_device, synchronize


@contextlib.contextmanager
def timed_parts(device, optimizer):
    """Inside the block, the step's parts run between synchronisations and
    add their seconds to the yielded bucket; -> (bucket, the optimizer
    with its update timed)."""
    bucket = collections.defaultdict(float)

    def timed(fn, label):
        def wrapped(*args, **kwargs):
            synchronize(device)
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                synchronize(device)
                bucket[label] += time.perf_counter() - t0
        return wrapped

    saved = [(steps, "lm_loss", "forward and loss"),
             (torch.autograd, "grad", "backward"),
             (steps, "global_norm", "gradient norm")]
    originals = [getattr(owner, name) for owner, name, _ in saved]
    for owner, name, label in saved:
        setattr(owner, name, timed(getattr(owner, name), label))
    try:
        yield bucket, optimizer._replace(
            step_=timed(optimizer.step_, "optimizer update"))
    finally:
        for (owner, name, _), fn in zip(saved, originals):
            setattr(owner, name, fn)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-4b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    model = build_model(cfg)
    if args.smoke:
        params = model.init(threefry.key(0), device)
    else:
        params = init_params_on_device(0, model.param_defs(), device)
    stream = make_token_stream(cfg.vocab_size, 400_000, seed=0)
    x, y = batch_token_stream(stream, args.batch, args.seq, 0)
    batch = {"tokens": torch.as_tensor(x, device=device),
             "labels": torch.as_tensor(y, device=device)}
    opt = adamw(3e-4)
    state = opt.init(params)
    step = steps.make_train_step(model, opt)
    step(params, state, batch)                       # warm-up
    synchronize(device)
    t0 = time.perf_counter()
    step(params, state, batch)
    synchronize(device)
    wall = time.perf_counter() - t0
    tokens = args.batch * args.seq
    print(f"{cfg.name}: {model.n_params:,} params, {cfg.num_layers} layers, "
          f"{args.batch} x {args.seq} tokens, grad_accum {cfg.grad_accum}, "
          f"remat {cfg.remat}: a step {wall * 1e3:.1f} ms, "
          f"{tokens / wall:,.0f} tokens/s ({card_label(device)})",
          flush=True)
    with timed_parts(device, opt) as (bucket, timed_opt):
        tstep = steps.make_train_step(model, timed_opt)
        synchronize(device)
        t0 = time.perf_counter()
        tstep(params, state, batch)
        synchronize(device)
        total = time.perf_counter() - t0
    bucket["accumulation and the rest"] = total - sum(bucket.values())
    print(f"parts, each between synchronisations: {total * 1e3:.1f} ms; "
          + ", ".join(f"{k} {v * 1e3:.1f} ms ({v / total:.1%})"
                      for k, v in sorted(bucket.items(),
                                         key=lambda kv: -kv[1])),
          flush=True)
    if device.type != "cuda":
        return
    torch.cuda.reset_peak_memory_stats()
    wall, kernels = device_profile(lambda: step(params, state, batch))
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    print(f"profiled step: {wall * 1e3:.1f} ms wall, device busy "
          f"{busy * 1e3:.1f} ms ({busy / wall:.2%}), peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    for e in kernels[:15]:
        t = e.self_device_time_total / 1e3
        print(f"  {t:9.2f} ms {t / 1e3 / busy:6.2%} x{e.count:<5d} "
              f"{e.key[:90]}", flush=True)


if __name__ == "__main__":
    main()

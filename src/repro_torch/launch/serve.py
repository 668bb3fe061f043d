"""Batched serving launcher: prefill a batch of prompts, decode greedily,
or (`--paged`) serve them through the block-table paged continuous-
batching loop.  Port of `repro.launch.serve`.

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --smoke
  PYTHONPATH=src python -m repro_torch.launch.serve --full \\
      --batch 8 --prompt-len 2048 --gen 32          # granite-20b on a card
  PYTHONPATH=src python -m repro_torch.launch.serve --full \\
      --arch falcon-mamba-7b --batch 4 --prompt-len 2048 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --full \\
      --arch recurrentgemma-9b --batch 2 --prompt-len 2048 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --paged
  PYTHONPATH=src python -m repro_torch.launch.serve --full --paged \\
      --batch 8 --prompt-len 512 --gen 32          # granite-20b, paged
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --smoke \\
      --arch qwen3-moe-235b-a22b                   # an MoE LM
  PYTHONPATH=src python -m repro_torch.launch.serve --full \\
      --arch phi-3-vision-4.2b --batch 8 --prompt-len 2048 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --full \\
      --arch seamless-m4t-large-v2 --batch 8 --prompt-len 2048 --gen 32

`main(argv)` builds the config from `--arch` / `--smoke` / `--full` and
hands it to `serve_config(cfg, args)`, which serves any ModelConfig: a
caller with a config of its own (a full-width model cut in depth to fit
one card, as chip_smoke.py serves the MoE archs) calls it with
`parse_args([...])`.

The batch (`make_batch`) is the reference's: random tokens, then for the
VLM stub `frontend_len` random patch embeddings that replace the prompt's
first positions, and for the enc-dec random frames of the prompt's
length, all drawn from one numpy generator seeded with `--seed`.

`--smoke` (the default) serves the arch's small config with the
reference's Threefry-drawn params; `--full` serves the published width
with params drawn on the device (`init_params_on_device`; not the JAX
package's numbers).  Prefill attention runs on the flash_attention kernel
(one launch per attention layer: an enc-dec's encoder, decoder self and
cross attention each), the SSM and RG-LRU scans on the linrec
kernel (one launch per recurrent layer in prefill and in each decode
step); the script prints the prefill and decode times and rates, the
launches of each kernel in the prefill and per decode step, and on a card
the peak device memory.

The weight layout and the cache spec come from the memory-aware policy
(dist/policy.py) through `pick_layout` on the host mesh
(launch/mesh.make_host_mesh): `--layout auto --cache auto` (the
defaults) let it decide, `--layout <name>` / `--cache <spec>` force one.
It prints `[serve] layout=... cache=... (peak ... GB/dev, headroom ...
GB) -- reason`, and on a card the measured peak beside the predicted one.
The fixed-batch path sizes the decision on the cache its prefill
allocates (prompt + models/cache.PREFILL_DECODE_MARGIN positions), so the
predicted cache bytes are the allocated ones (the reference sizes it on
prompt + gen); the paged path on prompt + gen, as the reference's.
On one card every layout places the same bytes: the decision picks the
cache spec, and reports the layout.

`--paged` (dense and MoE LMs without a sliding window) serves 2 x batch
requests of `--prompt-len` random tokens through `PagedServeLoop` with
`--batch` slots: they join as slots free up, the prompts stream through
the block pool in chunks of max(4 x block size, 32), and the pool
(`--num-blocks` of `--block-size` positions) defaults to batch x (prompt
+ gen) positions plus one block, as in the reference.  It prints the requests, tokens, tok/s, the pool,
the shared blocks and preemptions, the chunk and decode steps, ms per
decode tick and the kernel launches (the paged prefill attention is the
reference's plain route: no flash_attention launch).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import threefry
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.dist import policy as dist_policy
from repro_torch.dist.sharding import SERVE_LAYOUTS
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.linrec.kernel import linrec_cuda
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.serve_loop import PagedServeLoop, Request
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import build_model
from repro_torch.models.cache import PREFILL_DECODE_MARGIN, CacheSpec
from repro_torch.models.config import ShapeConfig
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


def pick_layout(model, mesh, *, batch: int, seq_len: int,
                layout: str = "auto", cache: str = "auto", hw=None):
    """Resolve the serve (weight layout, cache spec): the policy's
    analytic product decision for "auto"/"auto", else the named layout
    and/or CacheSpec (the full candidate table is still computed so the
    caller can log headroom)."""
    shape = ShapeConfig("serve", "decode", seq_len, batch)
    decision = dist_policy.analytic_serve_decision(model, shape, mesh, hw=hw)
    if cache != "auto" and model.supports_cache_spec:
        cache = CacheSpec.parse(cache).name
    if layout == "auto" and cache == "auto":
        return decision
    cands = [e for e in decision.evals
             if (layout == "auto" or e.layout == layout)
             and (cache == "auto" or e.cache == cache)
             and not e.chunked]
    if not cands:
        # a spec outside the candidate table (e.g. "ring:2/int8"):
        # evaluate the forced combination directly
        cands = [dist_policy.analytic_eval(
            model, shape, mesh,
            layout if layout != "auto" else decision.layout,
            cache_spec=None if cache == "auto" else cache, hw=hw)]
    cap = decision.budget_bytes * decision.margin
    fits = [e for e in cands if e.hbm_bytes <= cap]
    best = min(fits or cands, key=lambda e: e.step_time_s)
    if best.key != decision.key:
        decision = dataclasses.replace(
            decision, layout=best.layout, cache_spec=best.cache,
            chunked=best.chunked, fits=bool(fits),
            evals=decision.evals + tuple(
                e for e in cands if e not in decision.evals),
            reason=f"forced layout={layout} cache={cache} (policy "
                   f"preferred {decision.key}: {decision.reason})")
    return decision


def make_batch(cfg, rng: np.random.Generator, B: int, T: int,
               device) -> dict:
    """A prefill batch of B prompts of T positions, drawn from `rng` in the
    reference's order: tokens, then the VLM stub's patch embeddings (B,
    frontend_len, d_model), then the enc-dec's frames (B, T, d_model),
    the float draws cast to bf16."""
    batch = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32),
        device=device)}
    if cfg.frontend == "vision_stub":
        batch["patch_embeds"] = _bf16(
            rng.normal(size=(B, cfg.frontend_len, cfg.d_model)), device)
    if cfg.is_encdec:
        batch["frames"] = _bf16(rng.normal(size=(B, T, cfg.d_model)), device)
    return batch


def _bf16(x: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.bfloat16).to(device)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-20b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layout", default="auto",
                    choices=["auto"] + sorted(SERVE_LAYOUTS))
    ap.add_argument("--cache", default="auto",
                    help="KV-cache spec 'layout[:shards]/dtype' (e.g. "
                         "ring:4/int8, head/bf16); 'auto' lets the "
                         "policy pick (models/cache.py)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--paged", action="store_true",
                    help="serve through the block-table paged "
                         "continuous-batching loop (PagedServeLoop) "
                         "instead of the fixed-batch prefill+decode path")
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--num-blocks", type=int, default=0,
                    help="KV block pool size (default: sized so the pool "
                         "covers batch x (prompt+gen))")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    return serve_config(cfg, args)


def serve_config(cfg, args: argparse.Namespace) -> dict:
    """Serve `cfg` under the parsed options (`--arch` aside): its smoke
    params from the Threefry key with `--smoke`, params drawn on the
    device otherwise."""
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    model = build_model(cfg)
    B, S = args.batch, args.prompt_len + (
        args.gen if args.paged else PREFILL_DECODE_MARGIN)
    decision = pick_layout(model, make_host_mesh(), batch=B, seq_len=S,
                           layout=args.layout, cache=args.cache)
    if (model.supports_cache_spec and decision.cache_spec
            and decision.cache_spec != cfg.cache_spec):
        # params are spec-independent: only the cache tree changes shape
        cfg = dataclasses.replace(cfg, cache_spec=decision.cache_spec)
        model = build_model(cfg)
    t0 = time.perf_counter()
    if args.smoke:
        params = model.init(threefry.key(args.seed), device)
    else:
        params = init_params_on_device(args.seed, model.param_defs(), device)
    _sync(device)
    t_init = time.perf_counter() - t0
    if model.supports_cache_spec:
        cache_kind = CacheSpec.parse(cfg.cache_spec).name
    elif cfg.is_encdec:
        cache_kind = "self K/V and static cross K/V"
    else:
        cache_kind = f"{cfg.family} state"
    print(f"[serve] {cfg.name}: {model.n_params / 1e9:.2f} B params on "
          f"{device} (drawn in {t_init:.1f} s), cache {cache_kind}")
    print(f"[serve] layout={decision.layout}"
          + (f" cache={decision.cache_spec}" if decision.cache_spec else "")
          + f" (peak {decision.chosen.hbm_bytes/1e9:.2f} GB/dev, "
          f"headroom {decision.headroom_bytes()/1e9:.2f} GB) "
          f"-- {decision.reason}")

    if args.paged:
        res = _serve_paged(args, model, params, device, t_init,
                           decision.layout)
        res["decision"] = decision
        _peak_beside(device, decision)
        return res

    prefill = make_prefill_step(model)
    decode = make_decode_step(model)
    B, T = args.batch, args.prompt_len
    batch = make_batch(cfg, np.random.default_rng(args.seed), B, T, device)

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
    peak = _peak_gb(device)
    _peak_beside(device, decision)
    print(f"[serve] sample generations (first 12 ids): "
          f"{toks[:, :12].tolist()}")
    return {"model": model, "params": params, "tokens": toks,
            "prefill_s": t_prefill,
            "decode_s": t_dec, "decode_steps": args.gen - 1,
            "launches": {"prefill": pre_launches, "decode": dec_launches},
            "peak_gb": peak, "init_s": t_init, "decision": decision,
            "cache": cache}


def _peak_gb(device):
    if device.type != "cuda":
        return None
    peak = torch.cuda.max_memory_allocated(device) / 1e9
    print(f"[serve] peak device memory {peak:.2f} GB")
    return peak


def _peak_beside(device, decision):
    """On a card: the measured allocator peak beside the policy's."""
    if device.type != "cuda":
        return
    peak = torch.cuda.max_memory_allocated(device)
    print(f"[serve] peak measured {peak / 1e9:.2f} GB, predicted "
          f"{decision.chosen.hbm_bytes / 1e9:.2f} GB ({decision.key})")


def _serve_paged(args, model, params, device, t_init, layout) -> dict:
    """2 x batch requests through PagedServeLoop, drained tick by tick;
    the ticks that ran no prefill chunk are the decode ticks timed."""
    rng = np.random.default_rng(args.seed)
    B, T, bs = args.batch, args.prompt_len, args.block_size
    nb = args.num_blocks or -(-(B * (T + args.gen) + bs) // bs)
    loop = PagedServeLoop(model, params, max_batch=B, num_blocks=nb,
                          block_size=bs, chunk=max(bs * 4, 32),
                          layout=layout)
    for i in range(2 * B):   # oversubscribe: requests join mid-flight
        loop.submit(Request(rid=i, prompt=rng.integers(
            0, model.cfg.vocab_size, T).astype(np.int32), max_new=args.gen))
    before = _counts()
    done, decode_ticks = [], []
    t0 = time.perf_counter()
    while loop.live or loop.queue:
        chunks, t = loop.chunk_steps, time.perf_counter()
        done += loop.tick()          # ends in a copy of the tokens: synced
        if loop.chunk_steps == chunks:
            decode_ticks.append(time.perf_counter() - t)
    _sync(device)
    wall = time.perf_counter() - t0
    launches = _since(before)
    toks = sum(len(r.out) for r in done)
    tick_ms = 1e3 * sum(decode_ticks) / max(len(decode_ticks), 1)
    stats = loop.alloc.stats
    print(f"[serve] paged loop: {len(done)} reqs, {toks} tokens in "
          f"{wall * 1e3:.1f}ms ({toks / max(wall, 1e-9):.0f} tok/s); pool "
          f"{nb}x{bs}, shared {stats['shared_blocks']} blocks, "
          f"{loop.preemptions} preemptions; {loop.chunk_steps} chunk steps, "
          f"{loop.decode_steps} decode steps ({tick_ms:.2f} ms per decode "
          f"tick over {len(decode_ticks)}); kernel launches "
          f"{_show(launches)}")
    peak = _peak_gb(device)
    print(f"[serve] sample generations (first 12 ids): "
          f"{[r.out[:12] for r in done[:4]]}")
    return {"model": model, "params": params, "loop": loop, "done": done,
            "requests": len(done), "tokens_out": toks, "wall_s": wall,
            "tok_per_s": toks / max(wall, 1e-9), "pool": (nb, bs),
            "shared_blocks": stats["shared_blocks"],
            "preemptions": loop.preemptions,
            "chunk_steps": loop.chunk_steps,
            "decode_steps": loop.decode_steps, "decode_tick_ms": tick_ms,
            "launches": launches, "peak_gb": peak, "init_s": t_init}


if __name__ == "__main__":
    main()

"""How far an LM's last-position prefill logits move: the kernels against
the plain versions (the gap chip_smoke.py holds), one rounding nudged in
the plain path (the model's own noise floor), and faults planted in the
kernels' outputs (what that check must catch).  These readings set
chip_smoke.py's per-arch LM_LOGITS_TOL.

One arch at full width, params drawn on the card from seed 0 as
`launch/serve.py` draws them, and chip_smoke.py's check batch: 2 x 2,048
positions from numpy's default_rng(1) through `serve.make_batch` (tokens;
phi-3-vision's 576 patch embeddings; seamless-m4t's frames, as many as
the tokens).  The MoE archs, which do not fit one
card whole, keep their full width and are cut to chip_smoke.py's depth
(DEPTH_CUT: 8 layers).  Each reading is max |diff| /
max |plain| over the last position's logits, against the plain prefill:

  kernels      flash_attention and linrec as shipped
  nudge        the plain path with one bf16 ulp (x (1 + 2^-8)) nudged into
               0.1 % of the first mixer layer's outputs
  drop_head    the kernels, head 0 of the first attention layer zeroed
               (the decoder's self attention); for the enc-dec also
               drop_head_encoder and drop_head_cross, head 0 of the first
               encoder layer's and of the first cross attention's output
  half_window  the kernels, every attention layer at half its reach: half
               its window, or of the prompt where the window is none or
               reaches past the prompt
  lost_carry   the kernels, the first recurrent layer's scan restarted from
               zero LOST_CARRY_STEPS steps before the end

  PYTHONPATH=src python -m repro_torch.examples.logits_gap \
      --arch recurrentgemma-9b
  PYTHONPATH=src python -m repro_torch.examples.logits_gap \
      --arch mixtral-8x22b                      # 8 of its 56 layers
  PYTHONPATH=src python -m repro_torch.examples.logits_gap \
      --arch seamless-m4t-large-v2
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.linrec import ops as linrec_ops
from repro_torch.launch.serve import make_batch
from repro_torch.models import build_model, layers
from repro_torch.models.param import init_params_on_device
from repro_torch.runtime import resolve_device

BATCH, PROMPT = 2, 2048
#: layers kept of the archs that do not fit one card at full width
DEPTH_CUT = {"mixtral-8x22b": 8, "qwen3-moe-235b-a22b": 8}
NUDGE_FRACTION = 1e-3
LOST_CARRY_STEPS = 64


def nudge(i, fn, *args, **kw):
    out = fn(*args, **kw)
    if i:
        return out
    g = torch.Generator(device=out.device).manual_seed(0)
    hit = torch.rand(out.shape, generator=g, device=out.device) \
        < NUDGE_FRACTION
    return torch.where(hit, (out.float() * (1 + 2 ** -8)).to(out.dtype), out)


def attention_kinds(cfg) -> dict:
    """The index, among one prefill's attention calls, of the first call
    of each kind: the enc-dec's encoder runs all its layers first, then
    each decoder layer calls self and then cross attention."""
    if cfg.is_encdec:
        E = cfg.enc_layers
        return {"self": E, "encoder": 0, "cross": E + 1}
    return {"self": 0}


def drop_head_at(at: int):
    """A hook zeroing head 0 of the `at`-th attention call's output."""
    def hook(i, fn, q, k, v, **kw):
        out = fn(q, k, v, **kw)             # (B, T, H, D)
        if i == at:
            out = out.clone()
            out[:, :, 0] = 0
        return out
    return hook


drop_head = drop_head_at(0)


def half_window(i, fn, q, k, v, *, window=0, **kw):
    reach = min(window, q.shape[1]) if window else q.shape[1]
    return fn(q, k, v, window=reach // 2, **kw)


def lost_carry(i, fn, a, b, h0=None, **kw):
    if i:
        return fn(a, b, h0, **kw)
    t = a.shape[-2] - LOST_CARRY_STEPS
    head = fn(a[..., :t, :].contiguous(), b[..., :t, :].contiguous(), h0,
              **kw)
    tail = fn(a[..., t:, :].contiguous(), b[..., t:, :].contiguous(), None,
              **kw)
    return torch.cat([head, tail], dim=-2)


def prefill_logits(model, params, batch, *, impl="auto", attention=None,
                   scan=None):
    """Last-position logits (fp32) of one prefill; `attention` / `scan`
    wrap the layers' attention and scan calls as (layer index, the op,
    its arguments) -> output."""
    select, lin = layers.select_attention, linrec_ops.linrec
    seen = {"attention": 0, "scan": 0}

    def wrap(kind, op, hook):
        def call(*args, **kw):
            i = seen[kind]
            seen[kind] += 1
            return hook(i, op, *args, **kw)
        return call

    if attention:
        layers.select_attention = wrap("attention", select, attention)
    if scan:
        linrec_ops.linrec = wrap("scan", lin, scan)
    try:
        with torch.no_grad():
            logits, _ = model.apply(params, batch, mode="prefill",
                                    impl=impl)
    finally:
        layers.select_attention, linrec_ops.linrec = select, lin
    return logits[:, -1].float()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="recurrentgemma-9b")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    cfg = get_config(args.arch)
    layers_kept = DEPTH_CUT.get(args.arch, cfg.num_layers)
    model = build_model(dataclasses.replace(cfg, num_layers=layers_kept))
    params = init_params_on_device(0, model.param_defs(), dev)
    batch = make_batch(model.cfg, np.random.default_rng(1), BATCH, PROMPT,
                       dev)
    family = model.cfg.family
    has_attention, has_scan = family != "ssm", family in ("ssm", "hybrid")
    plain = prefill_logits(model, params, batch, impl="ref")
    runs = {"kernels": {}}
    if has_attention:
        runs["nudge"] = {"impl": "ref", "attention": nudge}
        for kind, at in attention_kinds(model.cfg).items():
            name = "drop_head" if kind == "self" else f"drop_head_{kind}"
            runs[name] = {"attention": drop_head_at(at)}
        runs["half_window"] = {"attention": half_window}
    else:
        runs["nudge"] = {"impl": "ref", "scan": nudge}
    if has_scan:
        runs["lost_carry"] = {"scan": lost_carry}
    scale = float(plain.abs().max())
    gaps = {}
    for name, kw in runs.items():
        got = prefill_logits(model, params, batch, **kw)
        gaps[name] = float((got - plain).abs().max()) / scale
        agree = int((got.argmax(-1) == plain.argmax(-1)).sum())
        print(f"{args.arch} full width, {layers_kept} of {cfg.num_layers} "
              f"layers, {BATCH}x{PROMPT} prefill, {name}: "
              f"last-position logits scale-relative max |diff| "
              f"{gaps[name]:.4g}, greedy agreement {agree}/{BATCH}",
              flush=True)
    print(json.dumps({"arch": args.arch, "layers": layers_kept,
                      "gaps": gaps}))


if __name__ == "__main__":
    main()

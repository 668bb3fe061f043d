"""How far the port's train step moves: under rounding alone, and under
faults planted in it.  These readings set the tolerances with which
tests/test_torch_train.py holds the port's train step against the JAX
package's and chip_smoke.py holds the card's step against the CPU's.

One smoke arch (or all twelve with --arch all), params from the
Threefry key of seed 0 (the JAX package's, to a few ulp), a batch of
B x T drawn from numpy's default_rng(0) over `Model.input_defs` (the
order and draws of the reference's tests/test_models_smoke.py), and
STEPS train steps of adamw (lr 1e-2, clip 1.0; --opt sgd: sgd_momentum).
Each run is held against the plain run on the same device by `gaps`:

  nudge        every nonzero param moved one ulp, up or down at random:
               the step's own noise floor, the scale of every param
               rounded apart at once
  no_clip      the gradient clip dropped (clip_norm = inf)
  bias_corr    adamw's bias corrections taken one count ahead
               (1 - b^(c+1) for 1 - b^c); sgd has none
  mask_shift   the loss mask one position longer: the first position (or
               the VLM's first position after its patch prefix) dropped

The readings, per arch (`gaps`): the metrics' gaps relative to the plain
run's values at each step, the adamw moments' rms gap relative to their
rms, and the params' gap: rms(new - new_plain) / rms(new_plain -
initial) over the tree and per leaf, and per leaf the slope of the
update on the plain run's.  Adam moves every weight by about lr whatever
its gradient's size, and its second update divides by the moments, so a
weight whose gradient is rounding noise (a key bias, whose gradient is
zero in exact arithmetic), or whose two gradients nearly cancel, moves by
about lr in a direction rounding decides: the params cannot tell a
rounding from a fault, the moments and the metrics can.

  PYTHONPATH=src python -m repro_torch.examples.train_gap --device cpu
  PYTHONPATH=src python -m repro_torch.examples.train_gap --device cpu \
      --arch all
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json

import numpy as np
import torch

from repro_torch import threefry
from repro_torch.configs import get_smoke_config, list_archs
from repro_torch.launch import steps
from repro_torch.models import build_model
from repro_torch.models.config import ShapeConfig
from repro_torch.optim import adamw, sgd_momentum
from repro_torch.runtime import resolve_device
from repro_torch.tree import leaves, tree_map

BATCH, SEQ, STEPS, LR = 2, 32, 2, 1e-2


def train_batch(model, B: int, T: int, seed: int = 0) -> dict:
    """numpy inputs of a train step at B x T, drawn from default_rng(seed)
    over the model's input_defs in their order: integers below the
    vocabulary for tokens and labels, normals for the rest (the caller
    casts them: bf16 for the LMs, fp32 images for the CNNs)."""
    rng = np.random.default_rng(seed)
    out = {}
    shape = ShapeConfig("train_gap", "train", T, B)
    for k, d in model.input_defs(shape).items():
        if d.dtype == torch.int32:
            hi = model.cfg.vocab_size if k in ("tokens", "labels") else T
            out[k] = rng.integers(0, max(hi, 2), d.shape).astype(np.int32)
        else:
            out[k] = rng.normal(size=d.shape)
    return out


def to_torch(batch: dict, model, device) -> dict:
    """The numpy batch as the port's inputs: int32, float inputs in the
    dtype input_defs gives them."""
    defs = model.input_defs(ShapeConfig("x", "train", 1, 1))
    return {k: torch.as_tensor(v).to(device=device, dtype=defs[k].dtype)
            for k, v in batch.items()}


def make_optimizer(name: str = "adamw", lr: float = LR):
    return {"adamw": lambda: adamw(lr),
            "sgd": lambda: sgd_momentum(lr)}[name]()


def run_steps(model, params, batch, *, n: int = STEPS, opt: str = "adamw",
              clip_norm: float = 1.0, count0: int = 0):
    """`n` train steps from copies of `params` on `batch` -> (params,
    optimizer state, [metrics as floats] a step).  `count0` starts the
    optimizer's count there (the bias_corr fault)."""
    optimizer = make_optimizer(opt)
    params = tree_map(torch.clone, params)
    state = optimizer.init(params)
    state["count"].fill_(count0)
    step = steps.make_train_step(model, optimizer, clip_norm=clip_norm)
    mets = []
    for _ in range(n):
        params, state, m = step(params, state, batch)
        mets.append({k: float(v) for k, v in m.items()})
    return params, state, mets


def _rms_gap(want, got) -> float:
    """rms(got - want) / rms(want) over the trees' leaves together."""
    num = den = 0.0
    for w, g in zip(leaves(want), leaves(got)):
        w, g = w.detach().double().cpu(), g.detach().double().cpu()
        num, den = num + float(((g - w) ** 2).sum()), \
            den + float((w ** 2).sum())
    return (num / den) ** 0.5 if den else 0.0


def gaps(initial, want, got) -> dict:
    """Two runs (params, state, metrics) from `initial` -> their readings:
      metric_step<k>  max over loss, xent, aux, grad_norm of the gap
                      relative to `want`'s value, at step k
      mu, nu          the moments' rms gap relative to their rms (adamw)
      update_tree     rms(got - want) / rms(want - initial) over the tree
      update_leaf     the same ratio per leaf, the largest
      slope_min       per leaf the regression slope of got's update on
                      want's, the smallest (1: the same update)."""
    (wp, ws, wm), (gp, gs, gm) = want, got
    out = {f"metric_step{s + 1}": max(
        abs(g[k] - w[k]) / max(abs(w[k]), 1e-6)
        for k in ("loss", "xent", "aux", "grad_norm"))
        for s, (w, g) in enumerate(zip(wm, gm))}
    for m in ("mu", "nu"):
        if m in ws:
            out[m] = _rms_gap(ws[m], gs[m])
    worst, num, den, slopes = 0.0, 0.0, 0.0, []
    for p0, w, g in zip(leaves(initial), leaves(wp), leaves(gp)):
        p0, w, g = (t.detach().double().cpu() for t in (p0, w, g))
        uw, ug = w - p0, g - p0
        d2, u2 = float(((g - w) ** 2).sum()), float((uw ** 2).sum())
        num, den = num + d2, den + u2
        if u2 > 0:
            worst = max(worst, (d2 / u2) ** 0.5)
            slopes.append(float((ug * uw).sum()) / u2)
        elif d2 > 0:
            worst = float("inf")
    out.update(update_tree=(num / den) ** 0.5 if den else 0.0,
               update_leaf=worst, slope_min=min(slopes, default=1.0))
    return out


#: what a train step is held to against another framework's or another
#: device's (tests/test_torch_train.py, chip_smoke.py), each between the
#: largest port-vs-JAX reading on the CPU and the planted faults this
#: module reads (PERF.md section 6): metrics at step 1 and step 2, the
#: moments (MoE archs apart: routing near ties), the params' tree, and
#: every leaf's update in the same direction.  The bf16 LMs take TOL;
#: the fp32 CNNs, whose steps round apart by 1e-5 at most (the card's
#: cuDNN 2.8e-4 in the params), TOL_FP32
TOL = {"metric_step1": 5e-3, "metric_step2": 1e-2, "moments": 0.1,
       "moe_moments": 0.15, "update_tree": 0.25, "slope_min": 0.2}
TOL_FP32 = {"metric_step1": 1e-4, "metric_step2": 1e-4, "moments": 1e-3,
            "update_tree": 2e-3, "slope_min": 0.99}


def violations(cfg, g: dict) -> list:
    """The readings `g` of a run of `cfg` that break its tolerances."""
    tol = TOL_FP32 if cfg.family == "cnn" else TOL
    bad = [k for k in ("metric_step1", "metric_step2", "update_tree")
           if k in g and not g[k] <= tol[k]]
    moments = tol["moe_moments" if cfg.num_experts else "moments"]
    bad += [m for m in ("mu", "nu") if m in g and not g[m] <= moments]
    if not g["slope_min"] >= tol["slope_min"]:
        bad.append("slope_min")
    return bad


_BITS = {torch.bfloat16: torch.int16, torch.float16: torch.int16,
         torch.float32: torch.int32}


def nudge_ulp_(params, seed: int = 1, chunk: int = 1 << 26):
    """Every nonzero float param one ulp up or down (a seeded coin per
    element), in place: +-1 on its bits, which moves a sign-magnitude
    float one ulp away from or toward zero.  Walks each leaf in chunks, so
    a full-width model needs no copy."""
    for p in leaves(params):
        bits = p.view(-1).view(_BITS[p.dtype])
        g = torch.Generator(device=p.device).manual_seed(seed)
        for i in range(0, bits.numel(), chunk):
            part = bits[i:i + chunk]
            step = torch.randint(0, 2, part.shape, generator=g,
                                 device=p.device, dtype=part.dtype) * 2 - 1
            zero = (part << 1) == 0          # +0 and -0 stay put
            part.add_(torch.where(zero, 0, step).to(part.dtype))
    return params


def nudge_ulp(params, seed: int = 1):
    return nudge_ulp_(tree_map(torch.clone, params), seed)


@contextlib.contextmanager
def mask_shift():
    """The lm_loss mask one position longer (the fault `mask_shift`)."""
    orig = steps.lm_loss

    def shifted(model, params, batch):
        # lm_loss masks the first frontend_len positions of a VLM: give
        # every model one masked position more
        cfg = model.cfg
        n = cfg.frontend_len if cfg.frontend == "vision_stub" else 0
        cfg = dataclasses.replace(cfg, frontend="vision_stub",
                                  frontend_len=n + 1)
        return orig(dataclasses.replace(model, cfg=cfg), params, batch)

    steps.lm_loss = shifted
    try:
        yield
    finally:
        steps.lm_loss = orig


def readings(arch: str, device, opt: str = "adamw") -> dict:
    """Every reading of one smoke arch on `device`."""
    model = build_model(get_smoke_config(arch))
    params = model.init(threefry.key(0), device)
    batch = to_torch(train_batch(model, BATCH, SEQ), model, device)
    plain = run_steps(model, params, batch, opt=opt)
    out = {"nudge": gaps(params, plain, run_steps(
        model, nudge_ulp(params), batch, opt=opt))}
    out["no_clip"] = gaps(params, plain, run_steps(
        model, params, batch, opt=opt, clip_norm=float("inf")))
    if opt == "adamw":
        out["bias_corr"] = gaps(params, plain, run_steps(
            model, params, batch, opt=opt, count0=1))
    if model.cfg.family != "cnn":
        with mask_shift():
            out["mask_shift"] = gaps(params, plain, run_steps(
                model, params, batch, opt=opt))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-4b",
                    help="a smoke arch, or 'all' for the twelve")
    ap.add_argument("--opt", default="adamw", choices=("adamw", "sgd"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    archs = list_archs() if args.arch == "all" else [args.arch]
    for arch in archs:
        print(json.dumps({"arch": arch, "opt": args.opt,
                          **readings(arch, device, args.opt)}), flush=True)


if __name__ == "__main__":
    main()

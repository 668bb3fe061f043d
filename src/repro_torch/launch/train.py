"""Federated training launcher, port of `repro.launch.train`.

P islands (the leading axis of every param, optimizer-state and batch
leaf), E local steps between weight exchanges, the exchange as one mixing
contraction (or two through fog cells, or a Byzantine-robust fold),
straggler-driven selection, delta compression, checkpoints and resume;
the same flags and the same `[train] step=... loss=... ...ms tag` lines as
the reference.  `--device` (default cuda) picks the card or the host.

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --smoke \\
      --steps 12 --islands 2 --local-steps 2 --batch 4 --seq 32
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-4b \\
      --full --islands 1 --steps 3 --batch 4 --seq 1024   # on a card

`--smoke` (the default) trains the arch's small config from the
reference's Threefry-drawn params; `--full` the published width, params
drawn on the device (`param.init_params_on_device`; not the JAX
package's numbers).  `main(argv, cfg=...)` trains any ModelConfig in
place of the registry's (a full-width model cut in depth, a custom
example model).  It returns the run: the final params and optimizer
state, the step losses, times and tags.

The train step (`launch/steps.py`) updates params and optimizer state in
place, so every tree the reference keeps beside them (the last-sync base,
the overlap snapshot, a robust fold broadcast to every island) is a copy
here (with one island there is no exchange and no base).  One deliberate
difference from the reference: a run resumed at an exchange step takes
the restored params as its last-sync base, where the reference keeps its
freshly drawn initial params, from which its next compressed delta and
its Byzantine attacks are then taken, so that its resumed run leaves the
uninterrupted one.  The island clock, which no checkpoint holds, starts
empty after a resume in both packages.

The loop's spans (`repro_torch.spans`, tagged with `step` and `round`):
`train.step` (the batch through the step's synchronise: what `step_ms`
times), `train.batch` inside it, `train.exchange` (selection, the wire's
faults, every route, the base copy) and `train.base_copy` inside it; the
step's and the exchange's own are in `launch/steps.py` and
`core/federated.py`.  `--trace` turns them on and prints at each
round's end, after its exchange, one `[trace] round=... <span>=<ms>ms
...` line of the round's summed stream times (`spans.spans()`: one
synchronise a round, which keeps the exchange's tail out of the next
step's `step_ms`).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import spans, threefry
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import aggregation
from repro_torch.core import compression as comp
from repro_torch.core import faults as faults_mod
from repro_torch.core import federated as fed
from repro_torch.core import hierarchy
from repro_torch.data.synthetic import batch_token_stream, make_token_stream
from repro_torch.launch.steps import make_fl_aggregate, make_fl_train_step
from repro_torch.models import build_model
from repro_torch.models.param import init_params_on_device
from repro_torch.optim import adamw, cosine_warmup
from repro_torch.runtime import resolve_device, synchronize
from repro_torch.tree import tree_map

#: the spans a `--trace` line sums, in its order
TRACE_LINE = ("step.forward", "step.backward", "step.optimizer",
              "exchange.delta", "exchange.quantise", "exchange.dequantise",
              "exchange.mix", "train.base_copy", "train.exchange")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-20b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--islands", type=int, default=2)
    ap.add_argument("--local-steps", type=int, default=4,
                    help="E: train steps between FL exchanges")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--compress", nargs="?", const="q8", default="none",
                    choices=["none", "q8", "topk", "q8-topk"],
                    help="delta compression on the exchange (bare flag = "
                         "q8)")
    ap.add_argument("--topk-frac", type=float, default=0.05,
                    help="kept fraction for the topk compression modes")
    ap.add_argument("--overlap", action="store_true",
                    help="double-buffer the exchange: round r's exchange "
                         "lands after round r+1's first local step "
                         "(1-step-stale; federated.fl_overlap_merge)")
    ap.add_argument("--fog-cells", type=int, default=1,
                    help="two-tier exchange: islands aggregate within fog "
                         "cells, then across cells (core/hierarchy.py)")
    ap.add_argument("--straggler-slack", type=float, default=3.0)
    ap.add_argument("--byzantine", type=float, default=0.0,
                    help="fraction of islands that ship corrupted updates "
                         "into every exchange (seeded faults.FaultPlan)")
    ap.add_argument("--byzantine-attacks", default="sign_flip,scale",
                    help="comma list from faults.ATTACKS")
    ap.add_argument("--byzantine-scale", type=float, default=10.0)
    ap.add_argument("--robust-agg", default="none",
                    choices=("none",) + aggregation.ROBUST_METHODS,
                    help="a Byzantine-robust fold of the island models in "
                         "place of the weighted mixing")
    ap.add_argument("--trim-frac", type=float, default=0.2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--trace", action="store_true",
                    help="record the loop's spans and print a [trace] line "
                         "of their stream times each round")
    return ap.parse_args(argv)


def _copy(tree):
    return tree_map(torch.clone, tree)


def trace_line(rnd: int, recorded) -> str:
    """`[trace] round=<rnd> <span>=<ms>ms ...`: each TRACE_LINE span's
    summed stream time over `recorded` (those with none left out)."""
    tot: dict = {}
    for sp in recorded:
        tot[sp.name] = tot.get(sp.name, 0.0) + sp.ms
    return " ".join([f"[trace] round={rnd}"] + [
        f"{n}={tot[n]:.2f}ms" for n in TRACE_LINE if n in tot])


def main(argv=None, *, cfg=None) -> dict:
    """Train; `cfg` (a ModelConfig) replaces the registry's config for
    --arch.  -> {"params", "opt_state", "losses", "step_ms", "tags",
    "metrics" (the last step's, as floats), "start"}."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    if args.trace:
        spans.enable()
    if cfg is None:
        cfg = get_smoke_config(args.arch) if args.smoke \
            else get_config(args.arch)
    model = build_model(cfg)
    P = args.islands
    compress = args.compress.replace("-", "_")
    opt = adamw(cosine_warmup(args.lr, 10, args.steps))
    step = make_fl_train_step(model, opt, P)
    agg = make_fl_aggregate(compress=compress, k_frac=args.topk_frac)
    clock = fed.IslandClock(P)

    if args.smoke:
        params = model.init(threefry.key(args.seed), device)
    else:
        params = init_params_on_device(args.seed, model.param_defs(), device)
    opt_state = opt.init(params)
    if P > 1:
        params = fed.stack_islands(params, P)
        opt_state = fed.stack_islands(opt_state, P)

    plan = None
    if args.byzantine > 0 and P > 1:
        plan = faults_mod.FaultPlan(faults_mod.FaultConfig(
            byzantine_frac=args.byzantine,
            attacks=tuple(args.byzantine_attacks.split(",")),
            scale_factor=args.byzantine_scale, seed=args.seed))
        print(f"[train] byzantine islands: {plan.byzantine_in(range(P))}")

    base_params = _copy(params) if P > 1 else None    # last-sync base
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    if mgr and args.resume and mgr.latest_step() is not None:
        start, params, opt_state, _ = mgr.restore(
            params_like=params, opt_state_like=opt_state)
        if P > 1 and start % args.local_steps == 0:
            base_params = _copy(params)  # an exchange step: params == base
        print(f"[train] resumed from step {start}")

    streams = [make_token_stream(cfg.vocab_size, 400_000, seed=args.seed + i)
               for i in range(P)]
    n_data = np.array([len(s) for s in streams], np.float64)

    def batch_at(s):
        xs, ys = zip(*(batch_token_stream(streams[i], args.batch, args.seq, s)
                       for i in range(P)))
        b = {"tokens": torch.as_tensor(np.stack(xs), device=device),
             "labels": torch.as_tensor(np.stack(ys), device=device)}
        if P == 1:
            b = {k: v[0] for k, v in b.items()}
        return b

    def dispatch_exchange(cur_params, sel):
        """This round's weighted exchange -> (mixed params | None, tag)."""
        w = (n_data / n_data.sum()) * sel
        if w.sum() <= 0:               # nobody selected -> no exchange
            return None, "no-exchange"
        if args.fog_cells > 1:
            # edge -> fog -> cloud: two narrow mixing hops (with
            # compression the edge hop stays cell-local)
            cell_of = np.arange(P) % args.fog_cells
            mixed = hierarchy.hierarchical_sync_aggregate(
                cur_params, w, cell_of, compress=compress,
                base_params=base_params if compress != "none" else None,
                k_frac=args.topk_frac)
            tag = f"fog-exchange x{args.fog_cells}"
        else:
            M = torch.as_tensor(
                fed.selection_mixing(n_data / n_data.sum(), sel),
                dtype=torch.float32, device=device)
            if compress != "none":
                mixed = agg(cur_params, base_params, M)
            else:
                mixed = agg(cur_params, M)
            tag = "exchange"
        if compress != "none":
            tag += f"+{args.compress}"
        return mixed, tag

    def robust_exchange(cur_params, ok: np.ndarray):
        """Byzantine-robust fold of the finite island models, which every
        island receives; with --compress the members first take the
        compressed delta wire and the finite gate re-runs on what it
        carries."""
        tag = f"robust-exchange:{args.robust_agg}"
        if compress != "none":
            cur_params = comp.roundtrip_islands(
                cur_params, base_params, mode=compress,
                k_frac=args.topk_frac)
            ok = ok & faults_mod.finite_members(cur_params)
            tag += f"+{args.compress}"
        keep = np.flatnonzero(ok)
        if keep.size == 0:
            return None, "no-exchange"
        idx = torch.as_tensor(keep, device=device)
        sub = tree_map(lambda l: l[idx], cur_params)
        kw = dict(trim_frac=args.trim_frac,
                  base=fed.island_slice(base_params, 0))
        if args.fog_cells > 1:
            agg_t = hierarchy.hierarchical_robust_aggregate(
                sub, keep % args.fog_cells, args.robust_agg, **kw)
        else:
            agg_t = aggregation.robust_aggregate_stacked(
                sub, args.robust_agg, **kw)
        # every island its own copy: the next step updates them in place
        mixed = tree_map(lambda a, l: a.to(l.dtype)[None].expand(l.shape)
                         .contiguous(), agg_t, cur_params)
        return mixed, tag

    def exchange_input(cur_params, rnd: int):
        """What the aggregator sees: Byzantine islands corrupt their update
        on the wire (an honest island's own state is never touched)."""
        if plan is None:
            return cur_params, np.ones(P, bool)
        out = cur_params
        for i in plan.byzantine_in(range(P)):
            sub = plan.corrupt(fed.island_slice(out, i),
                               fed.island_slice(base_params, i), i, rnd)
            out = tree_map(lambda l, c: torch.cat([l[:i], c[None],
                                                   l[i + 1:]]), out, sub)
        # the sanitization gate: a non-finite update never reaches the
        # fold, and its island's slices become its last-sync base (a zero
        # weight is not enough: 0 * nan = nan in the contraction)
        ok = faults_mod.finite_members(out)
        if not ok.all():
            bad = torch.as_tensor(~ok, device=device)
            out = tree_map(lambda l, b: torch.where(
                bad.reshape((-1,) + (1,) * (l.dim() - 1)), b, l),
                out, base_params)
        return out, ok

    losses, step_ms, tags = [], [], []
    metrics = {}
    pending = None   # (mixed, snapshot) while an overlapped exchange flies
    for s in range(start, args.steps):
        rnd = s // args.local_steps + 1
        spans.set_context(step=s + 1, round=rnd)
        t0 = time.perf_counter()
        with spans.span("train.step"):
            with spans.span("train.batch"):
                batch = batch_at(s)
            params, opt_state, metrics = step(params, opt_state, batch)
            tag = "local"
            if pending is not None:
                # round r's exchange ran from the snapshot while this step
                # ran: fold its correction in without recomputing the step
                mixed, snap = pending
                params = fed.fl_overlap_merge(params, mixed, snap)
                base_params = mixed
                pending = None
                tag = "local+merge"
            synchronize(device)
        dt = time.perf_counter() - t0
        clock.observe(np.full(P, dt))  # per-island step times (uniform)
        loss = metrics["loss"].cpu().numpy().mean()
        round_end = (s + 1) % args.local_steps == 0
        if round_end and P > 1:
            with spans.span("train.exchange"):
                sel = clock.selection(args.straggler_slack)
                ex_in, ok = exchange_input(params, rnd)
                if args.robust_agg != "none":
                    mixed, tag = robust_exchange(ex_in, ok)
                else:
                    mixed, tag = dispatch_exchange(ex_in, sel * ok)
                if mixed is None:
                    pass
                elif args.overlap and s + 1 < args.steps:
                    pending = (mixed, _copy(params))  # merge after next step
                    tag += "+overlap"
                else:
                    params = mixed
                    with spans.span("train.base_copy"):
                        base_params = _copy(mixed)
        print(f"[train] step={s+1} loss={loss:.4f} {dt*1e3:.0f}ms {tag}",
              flush=True)
        if args.trace and round_end:
            print(trace_line(rnd, spans.spans()), flush=True)
            spans.reset()
        losses.append(float(loss))
        step_ms.append(dt * 1e3)
        tags.append(tag)
        if mgr and (s + 1) % args.ckpt_every == 0:
            mgr.save(s + 1, params=params, opt_state=opt_state,
                     extra={"arch": args.arch, "islands": P})
            print(f"[train] checkpoint @ {s+1}")
    print("[train] done")
    spans.set_context()
    if args.trace:
        spans.disable()
    return {"params": params, "opt_state": opt_state, "losses": losses,
            "step_ms": step_ms, "tags": tags, "start": start,
            "metrics": {k: v.cpu().numpy().tolist()
                        for k, v in metrics.items()}}


if __name__ == "__main__":
    main()

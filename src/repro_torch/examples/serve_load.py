"""Serving load workload of the port: the JAX harness's
`benchmarks/serve_load.py` (the same ARCH, QPS, DURATION_S, POOL, load
configs, measure() and check_invariants()), on the port's loops.

Drives the block-table paged serve loop and the contiguous baseline with
the seeded open-loop generator (launch/loadgen.py) at the JAX harness's
target QPS on the granite smoke model (`--full`: its published width,
params drawn on the device), and reports p50/p99 request latency,
time-to-first-token and output tokens/s.  A shared-prefix workload
exercises prefix sharing; a parity pass replays the same trace through
both cache disciplines on a virtual clock.  The paged prefill's attention
rounds P to bf16 (the reference's plain route) where the contiguous
prefill's kernel keeps fp32, so the two runs' logits differ by rounding
and a greedy stream may leave the contiguous one where two logits nearly
tie.  Parity records the logits behind every token in both runs, holds
them within LOGITS_TOL (FULL_LOGITS_TOL at full width; scale-relative)
of each other while the streams share their context, and lets a stream
part only where the contiguous run's two best logits lie within twice
that step's difference (`divergence`); anything else is a mismatch.

  PYTHONPATH=src python -m repro_torch.examples.serve_load --device cpu
  PYTHONPATH=src python -m repro_torch.examples.serve_load     # the card

It prints one JSON object and writes no file: BENCH_serve.json is the JAX
package's.  Exit 1 when an invariant fails.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from repro_torch import threefry
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import loadgen
from repro_torch.launch.serve_loop import PagedServeLoop, ServeLoop
from repro_torch.launch.steps import (make_chunk_prefill_step,
                                      make_decode_step, make_prefill_step)
from repro_torch.models import build_model
from repro_torch.models.param import init_params_on_device
from repro_torch.runtime import card_label, resolve_device

ARCH = "granite-20b"
QPS = 12.0
DURATION_S = 3.0
# hard invariants, enforced every run (generous: CI boxes are slow)
P99_BOUND_MS = 20_000.0
TOKENS_PER_S_FLOOR = 5.0

POOL = dict(max_batch=4, num_blocks=48, block_size=8, chunk=32)
#: paged against contiguous logits while their streams agree, max |diff|
#: over the row's largest |logit|, each between what rounding moves them
#: (the largest over the parity trace's streams) and what a planted paged
#: fault does (the smallest over its streams): examples/parity_gap.py,
#: PERF.md section 6.  Smoke, the LM logits tolerance
#: (tests/test_torch_lm.py): rounding 0.0093 on the CPU, the fault 0.0929.
#: Full width on an H100: rounding 0.0241 (two runs equal but for the
#: shapes of their GEMMs read 0.0229), the fault 0.1495.
LOGITS_TOL = 2e-2
FULL_LOGITS_TOL = 5e-2


def _loops(model, params):
    paged = PagedServeLoop(model, params, **POOL)
    contiguous = ServeLoop(model, params, max_batch=POOL["max_batch"],
                           max_len=POOL["num_blocks"] * POOL["block_size"])
    return paged, contiguous


def _load_cfg(vocab, shared=False):
    return loadgen.LoadConfig(
        qps=QPS, duration_s=DURATION_S, seed=7, vocab_size=vocab,
        prompt_mean=20, prompt_max=80, out_mean=8, out_max=24,
        shared_prefix_frac=0.5 if shared else 0.0, shared_prefix_len=16)


def top2_gap(logits: torch.Tensor) -> np.ndarray:
    """(B, V) logits -> (B,) gap between each row's two best logits over
    the row's largest |logit|."""
    x = logits.float()
    top = x.topk(2, dim=-1).values
    return ((top[:, 0] - top[:, 1]) / x.abs().amax(dim=-1)).cpu().numpy()


def scale_relative(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max |want| (rows on any devices)."""
    want = want.float()
    got = got.float().to(want.device)
    return float((got - want).abs().max() / want.abs().max())


class LogitsRecorder:
    """A model whose apply keeps its last logits, for the serve steps
    (which return only the greedy token) to be read beside."""

    def __init__(self, model):
        self.model, self.logits = model, None

    def apply(self, *args, **kw):
        self.logits, cache = self.model.apply(*args, **kw)
        return self.logits, cache


def record_logits(loop) -> dict[int, dict[int, torch.Tensor]]:
    """Make a ServeLoop or a PagedServeLoop keep, per request, the logits
    row behind each token it emits (its prefill's last position, then
    each decode step's): -> {rid: {index in out: (V,) fp32 row}}, filled
    as the loop runs.  A preempted request's rows restart with it."""
    rec, rows, pending = LogitsRecorder(loop.model), {}, {}
    if isinstance(loop, PagedServeLoop):
        loop._chunk_prefill = make_chunk_prefill_step(rec)
        prefilled = "_prefill_chunks"     # (slot, ...): a prompt's chunks
    else:
        loop._prefill = make_prefill_step(rec)
        prefilled = "_write_slot"         # (slot, ...): after its prefill
    inner, decode = getattr(loop, prefilled), make_decode_step(rec)

    def prefilled_recorded(slot, *args):
        out = inner(slot, *args)
        pending[slot] = rec.logits[0, -1].float()
        return out

    def decode_recorded(*args):
        out = decode(*args)
        last = rec.logits[:, -1].float()
        for slot, req in loop.live.items():
            rows[req.rid][len(req.out)] = last[slot]
        return out

    admit = loop._admit

    def admit_recorded():
        before = dict(loop.live)
        admit()
        for slot, req in loop.live.items():
            if before.get(slot) is not req:
                rows[req.rid] = {0: pending.pop(slot)}

    setattr(loop, prefilled, prefilled_recorded)
    loop._decode, loop._admit = decode_recorded, admit_recorded
    return rows


def divergence(got: list, want: list, got_rows, want_rows,
               tol: float = LOGITS_TOL) -> tuple[str, float]:
    """Hold a greedy stream against another run's, with the logits behind
    each token (indexable by step).  While the two share their context --
    every step up to and including the first at which their tokens part --
    their logits must lie within tol of each other, scale-relative.  A
    parting is then a near-tie: `want`'s two best logits at that step lie
    within twice that step's difference, all a rounding of that size can
    swap (which holds whenever each token is its row's argmax).  -> ("equal"
    | "near_tie" | "mismatch", the largest difference over the shared
    steps)."""
    k = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
             None)
    n = min(len(got), len(want)) if k is None else k + 1
    diffs = [scale_relative(got_rows[i], want_rows[i]) for i in range(n)]
    worst = max(diffs, default=0.0)
    if worst > tol:
        return "mismatch", worst
    if k is None:
        return ("equal" if len(got) == len(want) else "mismatch"), worst
    gap = float(top2_gap(want_rows[k][None])[0])
    return ("near_tie" if gap <= 2 * diffs[k] else "mismatch"), worst


def replay(loop, trace, on_tick=None) -> dict:
    """The trace through `loop` on the virtual clock (tick_s = 0.01), the
    logits behind every token recorded; on_tick(loop), if given, runs
    after every tick.  -> {"records", "rows", "loop"}."""
    if on_tick is not None:
        tick = loop.tick

        def checked_tick():
            out = tick()
            on_tick(loop)
            return out
        loop.tick = checked_tick
    rows = record_logits(loop)
    records = loadgen.run_trace(loop, trace, tick_s=0.01)
    return {"records": records, "rows": rows, "loop": loop}


def compare(got: dict, want: dict, tol: float = LOGITS_TOL) -> dict:
    """Every stream of the replay `got` against the same request's in
    `want` (which may hold more) under `divergence` -> the verdicts, the largest logits
    difference over the steps the streams share (and over first tokens
    alone: a contiguous loop's first token is the request's solo
    prefill), the share of `want`'s steps whose two best logits lie
    within twice that difference (what the near-tie rule could excuse)
    and the tokens that agree."""
    by_rid = {w.rid: w for w in want["records"]}
    pairs = [(g, by_rid[g.rid]) for g in got["records"]]
    verdicts = [divergence(g.out, w.out, got["rows"][g.rid],
                           want["rows"][w.rid], tol) for g, w in pairs]
    kinds = [kind for kind, _ in verdicts]
    diff = max(d for _, d in verdicts)
    gaps = np.concatenate([top2_gap(torch.stack([r[i] for i in sorted(r)]))
                           for r in want["rows"].values()])
    return {"mismatches": kinds.count("mismatch"),
            "near_tie_streams": kinds.count("near_tie"),
            "logits_diff": diff,
            "first_token_diff": max(
                scale_relative(got["rows"][g.rid][0], want["rows"][w.rid][0])
                for g, w in pairs),
            "first_equal": sum(g.out[0] == w.out[0] for g, w in pairs),
            "near_tie_share": float((gaps <= 2 * diff).mean()),
            "tokens_agree": sum(a == b for g, w in pairs
                                for a, b in zip(g.out, w.out)),
            "tokens": sum(len(w.out) for _, w in pairs),
            "verdicts": verdicts}


def parity(model, params, trace, *, on_tick=None,
           tol: float = LOGITS_TOL) -> dict:
    """The trace through both disciplines on the virtual clock, the
    paged run held against the contiguous one (`compare`); on_tick
    (paged_loop), if given, runs after every paged tick.  -> compare's
    result, the request count, the paged loop's shared blocks,
    preemptions and steps, the contiguous loop's decode steps, and both
    replays ("paged", "contiguous")."""
    ploop, cloop = _loops(model, params)
    paged = replay(ploop, trace, on_tick)
    contiguous = replay(cloop, trace)
    return {**compare(paged, contiguous, tol),
            "n_requests": len(trace),
            "shared_blocks": ploop.alloc.stats["shared_blocks"],
            "preemptions": ploop.preemptions,
            "paged_steps": (ploop.chunk_steps, ploop.decode_steps),
            "contiguous_decode_steps": cloop.decode_steps,
            "paged": paged, "contiguous": contiguous}


def measure(model, params, tol: float = LOGITS_TOL) -> tuple[dict, dict]:
    vocab = model.cfg.vocab_size
    cells = {}

    # warm both loops outside the timed regions
    warm = loadgen.LoadConfig(qps=50, duration_s=0.2, seed=1,
                              vocab_size=vocab, prompt_mean=20,
                              prompt_max=80)
    for loop in _loops(model, params):
        loadgen.run_trace(loop, loadgen.generate(warm), tick_s=None)

    for name, shared, paged in (("paged_smoke", False, True),
                                ("paged_shared_prefix", True, True),
                                ("contiguous_smoke", False, False)):
        trace = loadgen.generate(_load_cfg(vocab, shared))
        ploop, cloop = _loops(model, params)
        loop = ploop if paged else cloop
        t0 = time.monotonic()
        records = loadgen.run_trace(loop, trace, tick_s=None)
        wall = time.monotonic() - t0
        cell = loadgen.summarize(records, wall)
        cell["qps"] = QPS
        if paged:
            cell["preemptions"] = loop.preemptions
            cell["shared_blocks"] = loop.alloc.stats["shared_blocks"]
            cell["evictions"] = loop.alloc.stats["evictions"]
        cells[name] = cell
        print(f"[serve_load] {name}: p50 {cell['p50_ms']}ms "
              f"p99 {cell['p99_ms']}ms  {cell['tokens_per_s']} tok/s "
              f"({cell['n_requests']} reqs)", flush=True)

    # parity: identical virtual-clock trace through both disciplines
    res = parity(model, params, loadgen.generate(_load_cfg(vocab, True)),
                 tol=tol)
    par = {k: res[k] for k in ("n_requests", "mismatches",
                               "near_tie_streams", "logits_diff",
                               "first_token_diff", "near_tie_share",
                               "tokens_agree", "tokens", "shared_blocks")}
    print(f"[serve_load] parity: {par['mismatches']}/{par['n_requests']} "
          f"mismatched, {par['near_tie_streams']} parted at a near-tie; "
          f"logits within {par['logits_diff']:.4g} scale-relative while "
          f"the streams agree (tol {tol}); "
          f"{par['tokens_agree']}/{par['tokens']} tokens agree "
          f"({par['shared_blocks']} prefix blocks shared)", flush=True)
    return cells, par


def check_invariants(cells: dict, parity: dict) -> list[str]:
    bad = []
    if parity["mismatches"]:
        bad.append(f"paged/contiguous token streams diverge: "
                   f"{parity['mismatches']}/{parity['n_requests']}")
    if parity["shared_blocks"] == 0:
        bad.append("shared-prefix workload shared no blocks")
    for name in ("paged_smoke", "paged_shared_prefix"):
        c = cells[name]
        if c["p99_ms"] > P99_BOUND_MS:
            bad.append(f"{name}: p99 {c['p99_ms']}ms > {P99_BOUND_MS}ms")
        if c["tokens_per_s"] < TOKENS_PER_S_FLOOR:
            bad.append(f"{name}: {c['tokens_per_s']} tok/s < "
                       f"{TOKENS_PER_S_FLOOR}")
    return bad


def load_model(device, full: bool = False):
    """ARCH's smoke config with the reference's Threefry params (seed 0),
    or (full) its published width with params drawn on the device."""
    if full:
        model = build_model(get_config(ARCH))
        return model, init_params_on_device(0, model.param_defs(), device)
    model = build_model(get_smoke_config(ARCH))
    return model, model.init(threefry.key(0), device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full", action="store_true",
                    help="ARCH at its published width (a card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    model, params = load_model(device, args.full)
    cells, par = measure(model, params,
                         FULL_LOGITS_TOL if args.full else LOGITS_TOL)
    bad = check_invariants(cells, par)
    print(json.dumps({
        "bench": "serve_load", "device": card_label(device),
        "arch": model.cfg.name,
        "workload": f"open-loop poisson {QPS} qps x {DURATION_S}s, "
                    "lognormal prompts / geometric outputs",
        "pool": POOL, "cells": cells, "parity": par, "failed": bad}))
    if bad:
        print(f"[serve_load] FAIL invariants: {bad}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

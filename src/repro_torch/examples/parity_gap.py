"""How far the paged loop's logits move from the contiguous loop's on
serve_load's parity trace: what rounding alone does, and what a paged
fault does.  These readings set serve_load's LOGITS_TOL (smoke) and
FULL_LOGITS_TOL (full width).

The shared-prefix parity trace (examples/serve_load.py: its POOL, the
virtual clock) through four replays, the logits behind every token
recorded in each:

  paged     PagedServeLoop as shipped (P rounded to bf16 in its prefill)
  flash     the contiguous ServeLoop as shipped (its prefill on the
            flash_attention kernel, P in fp32)
  matched   the contiguous ServeLoop with its prefill on the reference's
            XLA route (`attention_full`, P rounded to bf16): the paged
            loop's rounding points, only the shapes of the GEMMs differ
  fault     PagedServeLoop with a fault planted: the last row of every
            block reads as zeros (`planted_fault`)

and each pair held as serve_load.compare holds them: per stream, the
largest scale-relative logits difference over the steps the two streams
share; printed as the largest, median and smallest over the streams, with
the streams a tolerance would flag.

  PYTHONPATH=src python -m repro_torch.examples.parity_gap   # full width
  PYTHONPATH=src python -m repro_torch.examples.parity_gap --device cpu
"""
from __future__ import annotations

import argparse
import contextlib
import json

import torch

from repro_torch.examples import serve_load
from repro_torch.launch import loadgen
from repro_torch.models import layers
from repro_torch.runtime import card_label, resolve_device

PAIRS = (("paged", "flash"), ("paged", "matched"), ("matched", "flash"),
         ("fault", "flash"))


@contextlib.contextmanager
def reference_rounding():
    """Whole-sequence attention (train, prefill) on the reference's XLA
    route for up to 4,096 positions (`attention_full`: P rounded to bf16
    before PV) instead of the flash kernel (P in fp32): a contiguous loop
    at the paged loop's rounding points."""
    select = layers.select_attention

    def routed(q, k, v, *, q_offset=0, **kw):
        if isinstance(q_offset, int) and q_offset == 0 \
                and q.shape[1] == k.shape[1] <= 4096:
            return layers.attention_full(q, k, v,
                                         causal=kw.get("causal", True),
                                         window=kw.get("window", 0))
        return select(q, k, v, q_offset=q_offset, **kw)
    layers.select_attention = routed
    try:
        yield
    finally:
        layers.select_attention = select


@contextlib.contextmanager
def planted_fault():
    """A paged fault for parity to catch: the last row of every block
    reads as zeros in the gathered view (a block-offset error, 1 of
    block_size positions lost)."""
    gather = layers.paged_gather_kv

    def faulty(kp, vp, bt):
        k, v = gather(kp, vp, bt)
        bs = kp.shape[1]
        keep = (torch.arange(k.shape[1], device=k.device) % bs
                != bs - 1)[None, :, None, None]
        return k * keep, v * keep
    layers.paged_gather_kv = faulty
    try:
        yield
    finally:
        layers.paged_gather_kv = gather


def replays(model, params, trace) -> dict:
    """The four replays of the trace, by name."""
    runs = {}
    ploop, cloop = serve_load._loops(model, params)
    runs["paged"] = serve_load.replay(ploop, trace)
    runs["flash"] = serve_load.replay(cloop, trace)
    with reference_rounding():
        runs["matched"] = serve_load.replay(
            serve_load._loops(model, params)[1], trace)
    with planted_fault():
        runs["fault"] = serve_load.replay(
            serve_load._loops(model, params)[0], trace)
    return runs


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    full = device.type == "cuda"
    model, params = serve_load.load_model(device, full)
    tols = {"smoke": serve_load.LOGITS_TOL, "full": serve_load.FULL_LOGITS_TOL}
    trace = loadgen.generate(serve_load._load_cfg(model.cfg.vocab_size,
                                                  shared=True))
    runs = replays(model, params, trace)
    out = {}
    for got, want in PAIRS:
        r = serve_load.compare(runs[got], runs[want], tol=float("inf"))
        worst = sorted(d for _, d in r["verdicts"])
        out[f"{got}_vs_{want}"] = row = {
            "max": worst[-1], "median": worst[len(worst) // 2],
            "min": worst[0], "first_token_max": r["first_token_diff"],
            "flagged": {k: sum(d > t for d in worst)
                        for k, t in tols.items()},
            "near_tie_share": r["near_tie_share"],
            "tokens_agree": r["tokens_agree"], "tokens": r["tokens"]}
        print(f"{got} vs {want}: per-stream logits max |diff| / max "
              f"|logit| largest {row['max']:.4g}, median "
              f"{row['median']:.4g}, smallest {row['min']:.4g} over "
              f"{len(worst)} streams (first tokens: "
              f"{row['first_token_max']:.4g}); streams over the smoke "
              f"tolerance {tols['smoke']} {row['flagged']['smoke']}, over "
              f"the full-width {tols['full']} {row['flagged']['full']}; "
              f"steps within twice the largest of a tie "
              f"{row['near_tie_share']:.2%}; {row['tokens_agree']}/"
              f"{row['tokens']} tokens agree", flush=True)
    print(json.dumps({"device": card_label(device), "arch": model.cfg.name,
                      "full": full, "readings": out}))
    return out


if __name__ == "__main__":
    main()

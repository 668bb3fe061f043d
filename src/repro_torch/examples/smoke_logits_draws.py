"""How the recurrent smoke models' kernels-vs-plain prefill logits spread
over token draws, and whether the scan kernel repeats its bits.

`tests/test_torch_cuda.py::test_one_linrec_launch_per_recurrent_layer`
holds one (2, 37) prefill of each recurrent smoke model, kernels against
plain versions, within rtol = atol = 2e-2.  This reads that gap over
`--draws` token draws (seeds 0, 1, ...): the worst |diff|, and the draws
outside the tolerance, each rerun with attention on its plain version so
that a gap left is the scan's.  Every scan of the first `--repeat-draws`
draws is launched `--repeats` more times on the same inputs and must give
the same bits as the first launch and as ref.py.

  PYTHONPATH=src python -m repro_torch.examples.smoke_logits_draws
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch import threefry
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.linrec import kernel as linrec_kernel
from repro_torch.kernels.linrec import ops as linrec_ops
from repro_torch.kernels.linrec.ref import linrec_ref
from repro_torch.models import build_model, layers
from repro_torch.runtime import resolve_device

ARCHS = ("falcon-mamba-7b", "recurrentgemma-9b")
BATCH, PROMPT, TOL = 2, 37, 2e-2


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--draws", type=int, default=1000)
    ap.add_argument("--repeat-draws", type=int, default=40)
    ap.add_argument("--repeats", type=int, default=10)
    args = ap.parse_args()
    dev = resolve_device(args.device)
    scan, select = linrec_ops.linrec, layers.select_attention
    scans, unequal, repeats = 0, [], [0]

    def held_scan(a, b, h0=None, *, impl="auto"):
        nonlocal scans
        out = scan(a, b, h0, impl=impl)
        if impl == "ref":
            return out
        scans += 1
        shape = (tuple(a.shape), linrec_kernel.route(a, b))
        if not torch.equal(out, linrec_ref(a, b, h0)):
            unequal.append(("ref.py", shape))
        for _ in range(repeats[0]):
            if not torch.equal(scan(a, b, h0, impl=impl), out):
                unequal.append(("repeat", shape))
        return out

    def plain_attention(q, k, v, **kw):
        return select(q, k, v, **{**kw, "impl": "ref"})

    def prefill(model, params, toks, **kw):
        with torch.no_grad():
            return model.apply(params, {"tokens": toks}, mode="prefill",
                               **kw)[0].float()

    linrec_ops.linrec = held_scan
    report = {"device": torch.cuda.get_device_name(0)
              if dev.type == "cuda" else "cpu", "archs": {}}
    try:
        for arch in ARCHS:
            model = build_model(get_smoke_config(arch))
            params = model.init(threefry.key(0), dev)
            worst, outside = 0.0, []
            for seed in range(args.draws):
                repeats[0] = args.repeats if seed < args.repeat_draws else 0
                g = torch.Generator(device=dev).manual_seed(seed)
                toks = torch.randint(0, model.cfg.vocab_size,
                                     (BATCH, PROMPT), generator=g,
                                     device=dev, dtype=torch.int32)
                got = prefill(model, params, toks)
                want = prefill(model, params, toks, impl="ref")
                diff = (got - want).abs()
                worst = max(worst, float(diff.max()))
                if bool((diff > TOL + TOL * want.abs()).any()):
                    layers.select_attention = plain_attention
                    try:
                        scan_only = prefill(model, params, toks)
                    finally:
                        layers.select_attention = select
                    outside.append({
                        "seed": seed, "max_abs_diff": float(diff.max()),
                        "plain_attention_max_abs_diff":
                            float((scan_only - want).abs().max())})
            report["archs"][arch] = {"draws": args.draws, "worst": worst,
                                     "outside_tolerance": outside}
            print(f"{arch}: {args.draws} draws, worst |diff| {worst:.4g}, "
                  f"{len(outside)} outside rtol = atol = {TOL}", flush=True)
            for o in outside:
                print(f"  seed {o['seed']}: {o['max_abs_diff']:.4g}; with "
                      f"plain attention {o['plain_attention_max_abs_diff']:.4g}",
                      flush=True)
    finally:
        linrec_ops.linrec = scan
    report.update(scans=scans, unequal_scans=len(unequal))
    print(f"linrec: {scans} scans, {len(unequal)} not bit-equal to ref.py "
          "or to their own first launch", flush=True)
    print(json.dumps(report))
    return 1 if unequal else 0


if __name__ == "__main__":
    raise SystemExit(main())

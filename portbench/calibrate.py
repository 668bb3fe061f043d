"""Readings that the limits of `correct` are set from; never run by a
benchmark run.

    python3 -m portbench.calibrate --workload <name> --seeds 1,2,3 \\
        [--program] [--variants fp8,half_batch,no_exchange] [--seconds 2]

`--program` runs the cell (a short window) on each seed and prints the
program's numbers against the reference; `--variants` puts the control
(`fp8`: the reference's products in float8) or a planted fault in the
program's place and prints its numbers against the float32 reference.
One process reads every seed, so set-up and builds are paid once.  One
JSON line a reading: {"seed", "who", "numbers"}."""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time

from portbench import core, judge
from portbench import run as prun


def readings(manifest, wname, seeds, *, program: bool, variants: list,
             seconds: float, device: str, config=None, traffic=None):
    import torch
    wl = core.workload(manifest, wname)
    cfg = config or core.config_of(manifest, wl["config"])
    tr = traffic or core.traffic_of(wl["traffic"])
    drv = core.driver(tr["driver"])
    out = []
    for seed in seeds:
        measured = ref = None
        if program:
            run, measured, ref, nums, _ = prun.measure(
                manifest, wname, seed=seed, seconds=seconds, trace=False,
                device=device, t0=time.perf_counter(), config=cfg,
                traffic=tr)
            out.append({"seed": seed, "who": "program", "numbers": nums})
            if "grad" in nums:      # the leaves a training reading comes from
                for k in ("grad", "change"):
                    g = judge.leaf_gaps(measured["program"][k], ref[k])
                    out[-1][k + "_leaves"] = sorted(
                        g.items(), key=lambda kv: -kv[1])[:3]
            print(json.dumps(out[-1]), flush=True)
        if variants:
            if measured is None:
                run = core.Run(wname, cfg, tr, seed, seconds, False,
                               torch.device(device))
                measured = drv.plan(run)
                ref = drv.reference(run, measured)
            for v in variants:
                nums = drv.variant_numbers(run, measured, ref, v)
                out.append({"seed": seed, "who": v, "numbers": nums})
                print(json.dumps(out[-1]), flush=True)
                gc.collect()
        del measured, ref
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--variants", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    prun._environment()
    import torch
    if not torch.cuda.is_available():
        print("portbench.calibrate: no CUDA device", file=sys.stderr)
        return 2
    readings(core.load_manifest(), args.workload,
             [int(s) for s in args.seeds.split(",")], program=args.program,
             variants=[v for v in args.variants.split(",") if v],
             seconds=args.seconds, device="cuda")
    return 0


if __name__ == "__main__":
    sys.exit(main())

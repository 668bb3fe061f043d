"""Entry point of the paper's experiment suite on the port, after the JAX
package's `benchmarks/run.py`: one bench per paper figure, FedOpt, and the
framework overhead.  Prints the figures' curve/tta/summary rows and
`name,us_per_call,derived` rows, and `bench.<name>,<wall us>,wall_us`
after each.

  PYTHONPATH=src python -m repro_torch.examples.paper.run \\
      [--only fig12,...,fig18,fedopt,overhead] [--seed N] [--device cpu]

`--seed` reaches every bench.  The JAX package's roofline reader has no
counterpart yet (it reads the XLA planning layer's dry-run artifacts), so
asking for it raises.
"""
from __future__ import annotations

import argparse
import time

from repro_torch.examples.paper import (beyond_fedopt, fig12_sequential_vs_fl,
                                        fig13_even_vs_uneven,
                                        fig14_random_vs_sequential,
                                        fig15_rminmax, fig16_rmax_init,
                                        fig17_alg2_sync, fig18_async,
                                        overhead)

BENCHES = {
    "fig12": fig12_sequential_vs_fl.main,
    "fig13": fig13_even_vs_uneven.main,
    "fig14": fig14_random_vs_sequential.main,
    "fig15": fig15_rminmax.main,
    "fig16": fig16_rmax_init.main,
    "fig17": fig17_alg2_sync.main,
    "fig18": fig18_async.main,
    "fedopt": beyond_fedopt.main,
    "overhead": overhead.main,
}


def main(argv=None) -> dict:
    """-> {bench: (its main's return value, wall seconds)}, in run order."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=None,
                    help="comma list: fig12,...,fig18,fedopt,overhead")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    only = args.only.split(",") if args.only else list(BENCHES)
    for name in only:
        if name == "roofline":
            raise NotImplementedError(
                "roofline: the roofline reader comes with the planning "
                "layer's port (ROADMAP queue 1, 'Planning layer')")
        if name not in BENCHES:
            raise ValueError(f"unknown bench {name!r}; have "
                             f"{sorted(BENCHES)}")
    out = {}
    for name, fn in BENCHES.items():
        if name not in only:
            continue
        print(f"=== {name} ===", flush=True)
        t0 = time.perf_counter()
        res = fn(seed=args.seed, device=args.device)
        wall = time.perf_counter() - t0
        print(f"bench.{name},{wall * 1e6:.0f},wall_us", flush=True)
        out[name] = (res, wall)
    return out


if __name__ == "__main__":
    main()

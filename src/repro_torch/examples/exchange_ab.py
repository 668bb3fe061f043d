"""The q8 exchange of an older tree of the port against this one, in
alternating processes on one card.

Pair i runs `profile_exchange.py --quick` (the median of 5 runs of 20
P = 8 q8 exchanges, flat and through 2 fog cells) once with the older
tree's sources and once with this tree's, the older tree first in even
pairs.  For each cell it prints every pair, both trees' medians and
quartiles, and the pairs in which this tree was faster than the older one
by more than the older tree's interquartile range; the change counts as
a gain only where that holds in at least 9 of 10 pairs.

  python src/repro_torch/examples/exchange_ab.py --base <older tree>/src
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parents[2]
SCRIPT = Path(__file__).resolve().parent / "profile_exchange.py"


def one_run(src: Path) -> dict:
    env = dict(os.environ, PYTHONPATH=str(src))
    proc = subprocess.run([sys.executable, str(SCRIPT), "--quick"], env=env,
                          capture_output=True, text=True, check=True)
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", required=True, type=Path,
                    help="the older tree's src directory")
    ap.add_argument("--pairs", type=int, default=10)
    args = ap.parse_args()
    runs = {"base": [], "change": []}
    for i in range(args.pairs):
        order = ("base", "change") if i % 2 == 0 else ("change", "base")
        got = {}
        for who in order:
            got[who] = one_run(args.base if who == "base" else SRC)
            runs[who].append(got[who])
        print(f"pair {i} ({order[0]} first): " + "; ".join(
            f"{cell} {got['base'][cell]:.4f} -> {got['change'][cell]:.4f} ms"
            for cell in got["base"]), flush=True)
    for cell in runs["base"][0]:
        base = np.array([r[cell] for r in runs["base"]])
        change = np.array([r[cell] for r in runs["change"]])
        q1, q3 = np.percentile(base, [25, 75])
        wins = int(np.sum(base - change > q3 - q1))
        print(f"{cell}: older tree median {np.median(base):.4f} ms "
              f"(quartiles {q1:.4f}, {q3:.4f}), this tree median "
              f"{np.median(change):.4f} ms (quartiles "
              f"{np.percentile(change, 25):.4f}, "
              f"{np.percentile(change, 75):.4f}); faster by more than the "
              f"older tree's interquartile range {q3 - q1:.4f} ms in {wins} "
              f"of {args.pairs} pairs: "
              f"{'a gain' if wins >= 0.9 * args.pairs else 'unresolved'}",
              flush=True)


if __name__ == "__main__":
    main()

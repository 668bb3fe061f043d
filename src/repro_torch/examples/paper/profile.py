"""Where the paper suite's time goes on the card.

For each figure (and FedOpt) at seed 0: its wall time, and the share of it
spent in local training, evaluation and the server's merge (each call
timed between synchronisations, `profile_quickstart.py`'s method, on every
simulation the figure builds); the rest is the event engine, selection and
host code.  Then fig18's async run (Alg. 2, 320 merges) alone, the same
split, and under `torch.profiler` its device busy share and kernels by
device time.

  PYTHONPATH=src python -m repro_torch.examples.paper.profile [--only fig18]
"""
from __future__ import annotations

import argparse
import contextlib
import io
import subprocess

from repro_torch.examples.paper import common
from repro_torch.examples.paper.run import BENCHES
from repro_torch.examples.profile_quickstart import (device_profile,
                                                     layer_times, report,
                                                     report_kernels)


def fig18_async():
    sim = common.build_sim(table_config=2, policy="time_based",
                           mode="async", seed=0)
    return common.run(sim, mode="async", merges=320, target=0.99)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=None,
                    help="comma list of figures (default: all but overhead)")
    args = ap.parse_args(argv)
    only = args.only.split(",") if args.only else \
        [b for b in BENCHES if b != "overhead"]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    with contextlib.redirect_stdout(io.StringIO()):   # warm-up: cuBLAS,
        BENCHES["fig18"](rounds=2, merges=4)          # the fed_agg build
    for name in only:
        with layer_times() as bucket, \
                contextlib.redirect_stdout(io.StringIO()):
            BENCHES[name](seed=0)
        report(name, bucket)
    with layer_times() as bucket:
        fig18_async()
    report("fig18 async run (320 merges)", bucket)
    report_kernels(*device_profile(fig18_async))


if __name__ == "__main__":
    main()

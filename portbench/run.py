"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

Exits 2 and prints no result where CUDA is missing or the card count is
under the cell's, or where a module of JAX or of the JAX package is
loaded once the window has closed.  Everything the program builds or
caches stays inside the checkout or under HOME, XDG_CACHE_HOME and
TMPDIR."""
import time

T_IMPORT = time.perf_counter()       # before torch: set-up counts from here

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from portbench import core, judge  # noqa: E402


def _since_process_start() -> float:
    """Seconds from this process's creation to T_IMPORT (0 where /proc
    cannot say)."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK")
                   - (time.perf_counter() - T_IMPORT))
    except (OSError, ValueError, IndexError):
        return 0.0


def _environment() -> None:
    """Fixed cache directories inside the checkout for anything compiled
    through torch or triton (the program's own CUDA libraries are built
    into its fixed `kernels/_build/` directory), and the program on the
    path."""
    cache = core.ROOT / "portbench" / "_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    src = str(core.ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def measure(manifest: dict, wname: str, *, seed: int, seconds: float,
            trace: bool, device, t0: float, pre: float = 0.0,
            config=None, traffic=None):
    """Run the cell, then its reference -> (run, measured, reference
    readings, numbers compared, setup_s).  `config` and `traffic` default
    to the files the manifest names."""
    import torch

    wl = core.workload(manifest, wname)
    run = core.Run(wname,
                   config or core.config_of(manifest, wl["config"]),
                   traffic or core.traffic_of(wl["traffic"]),
                   seed, seconds, trace, torch.device(device))
    drv = core.driver(run.traffic["driver"])
    measured = drv.run(run)
    setup_s = pre + run.record.facts["setup_end"] - t0
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = drv.reference(run, measured)
    run.record.facts["reference_s"] = time.perf_counter() - t_ref
    return run, measured, ref, drv.numbers(measured, ref), setup_s


def execute(manifest: dict, wname: str, *, seed: int, seconds: float,
            trace: bool, device, t0: float, pre: float = 0.0,
            config=None, traffic=None, limits=None) -> dict:
    """Run the cell and judge it -> the result dict."""
    import torch

    run, _, _, numbers, setup_s = measure(
        manifest, wname, seed=seed, seconds=seconds, trace=trace,
        device=device, t0=t0, pre=pre, config=config, traffic=traffic)
    rec = run.record
    wl = core.workload(manifest, wname)
    ok, checks = judge.decide(numbers, limits or core.limits_of(wname))

    if trace:
        metrics = {}
        for m in core.per_layer_for(manifest, wname):
            v = core.metric_reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = dict(rec.end_to_end, setup_s=setup_s)
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in core.end_to_end_for(manifest, wname)}
    dev = {"platform": "gpu" if run.device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(0)
                    if run.device.type == "cuda" else "cpu"),
           "count": wl["chips"], "memory_peak_bytes": rec.peak_bytes}
    out = {"correct": ok, "attempted": rec.counters.get("attempted", 0),
           "failed": rec.counters.get("failed", 0), "metrics": metrics,
           "device": dev}
    if trace:
        if rec.trace is None:
            raise RuntimeError("the traced run recorded no trace")
        dev["busy_s"] = rec.trace.busy_s()
        dev["window_s"] = rec.trace.window_s
        out["breakdown"] = {"device_ops": rec.trace.top_ops(10),
                            "idle_gaps": rec.trace.idle_gaps(10)}
    out["reference_s"] = rec.facts["reference_s"]
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    pre = _since_process_start()
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    manifest = core.load_manifest()
    wl = core.workload(manifest, args.workload)
    _environment()
    import torch
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < wl["chips"]:
        print(f"portbench: the cell needs {wl['chips']} CUDA device(s); "
              f"this machine has {have}", file=sys.stderr)
        return 2
    out = execute(manifest, args.workload, seed=args.seed,
                  seconds=args.seconds, trace=bool(args.trace),
                  device="cuda", t0=T_IMPORT, pre=pre)
    bad = core.forbidden_modules(sys.modules)
    if bad:
        print(f"portbench: modules of JAX or of the JAX package are loaded: "
              f"{bad}", file=sys.stderr)
        return 2
    judge.print_checks(out["checks"])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100).

  python3 chip_smoke.py

Phases, in order; any failure exits non-zero and nothing is caught:
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the fed_agg CUDA kernel from src/repro_torch/kernels/fed_agg/csrc;
  3. hold the kernel against its plain version over K x N x dtype, with its
     time, the plain version's, one torch.einsum call's (a yardstick the
     port never calls) and the least time the card could take;
  4. the main path: the port's quickstart on the card (Alg. 2, async, 80
     merges, seed 0), which must launch the kernel; the same run at seeds
     1-7, whose median best accuracy must be within 0.03 of the JAX
     quickstart's median over the same seeds; then a 3-round sync run
     twice, through the kernel and through the plain version, which must
     agree;
  5. print the kernel table as JSON, then the result line.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory (NVIDIA data sheet)
FP32_FLOPS_PER_S = 67e12     # H100 SXM fp32 outside the tensor cores
# Best accuracy of the JAX package's quickstart run (examples/quickstart.py
# fixes seed 0) after 80 async merges, on the CPU, per seed, as printed by
# `PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_events.py`.
# One seed's best accuracy is not a stable target: a few-ulp change of the
# initial params moves the JAX run's own seed-0 value from 0.800 to 0.839.
# The median over eight seeds is held instead.
JAX_BEST_ACC = {0: 0.7998, 1: 0.9092, 2: 0.9424, 3: 0.9121,
                4: 0.9307, 5: 0.8828, 6: 0.9189, 7: 0.7080}
ACC_TOL = 0.03
MAIN_SHAPE = (2, 20_490, "float32")   # async merge of flight-cnn-mnist


def check(ok: bool, msg: str):
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def graph_ms(torch, fn, iters: int) -> float:
    """Device time of one call: `iters` calls captured in one CUDA graph
    and replayed, so host-side launch cost is left out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def eager_ms(torch, fn, iters: int) -> float:
    """Time of one call issued from Python, as the main path issues it:
    for a small input this is the host's launch cost."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def kernel_sweep(torch, np):
    from repro_torch.kernels.fed_agg.kernel import fed_agg_cuda
    from repro_torch.kernels.fed_agg.ref import fed_agg_2d_ref
    rows = []
    g = torch.Generator(device="cuda").manual_seed(0)
    rng = np.random.default_rng(0)
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        for K in (1, 2, 5, 8):
            for N in (128, 5_000, 20_490, 1 << 24):
                x = torch.randn(K, N, generator=g, device="cuda").to(dtype)
                w = torch.as_tensor(rng.dirichlet([1.0] * K),
                                    dtype=torch.float32).cuda()
                got = fed_agg_cuda(x, w)
                want = fed_agg_2d_ref(x, w)
                torch.cuda.synchronize()
                torch.testing.assert_close(got.float(), want.float(),
                                           rtol=tol, atol=tol)
                err = float((got.float() - want.float()).abs().max())
                wl = w.to(dtype)
                iters = 200 if N <= 20_490 else 20
                ms = graph_ms(torch, lambda: fed_agg_cuda(x, w), iters)
                plain = graph_ms(torch, lambda: fed_agg_2d_ref(x, w), iters)
                lib = graph_ms(torch, lambda: torch.einsum("kn,k->n", x, wl),
                               iters)
                call = eager_ms(torch, lambda: fed_agg_cuda(x, w), iters)
                nbytes = (K + 1) * N * x.element_size() + 4 * K
                flops = 2 * K * N
                t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                t_ops = flops / FP32_FLOPS_PER_S * 1e3
                row = {"K": K, "N": N, "dtype": str(dtype).split(".")[-1],
                       "max_abs_err": err, "tol": tol, "ms": ms,
                       "plain_ms": plain, "library_ms": lib,
                       "call_ms": call, "bound_ms": max(t_bytes, t_ops),
                       "bound_by": "bytes" if t_bytes >= t_ops
                       else "operations"}
                rows.append(row)
                print(f"fed_agg K={K} N={N} {row['dtype']}: "
                      f"err={err:.3g} (tol {tol}) kernel={ms:.5f} ms "
                      f"plain={plain:.5f} ms einsum={lib:.5f} ms "
                      f"bound={row['bound_ms']:.5f} ms ({row['bound_by']}, "
                      f"{row['bound_ms'] / ms:.1%} of it) "
                      f"python call={call:.5f} ms", flush=True)
    return rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 1
    import numpy as np

    from repro_torch.examples import quickstart
    from repro_torch.kernels.fed_agg import kernel
    from repro_torch.runtime import resolve_device
    from repro_torch.tree import leaves

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    resolve_device("cuda")   # TF32 off, cuDNN deterministic (runtime.py)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    # 2. build from the checkout's sources
    t0 = time.perf_counter()
    lib_path = kernel.library()._name
    print(f"built fed_agg in {time.perf_counter() - t0:.1f} s -> "
          f"{Path(lib_path).relative_to(ROOT)}", flush=True)

    # 3. kernel vs plain version (launches here are not the main path's)
    rows = kernel_sweep(torch, np)

    # 4. main path: the quickstart on the card, counted from zero
    kernel.fed_agg_cuda.launches = 0
    t0 = time.perf_counter()
    result = quickstart.run("cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel.fed_agg_cuda.launches
    merges = result.records[-1].round
    print(f"quickstart (cuda): {wall:.2f} s wall, {merges} merges, "
          f"{launches} fed_agg launches ({launches / max(merges, 1):.2f} "
          f"per merge)", flush=True)
    check(launches > 0, "the main path launched no fed_agg kernel")

    best = {}
    for seed in JAX_BEST_ACC:
        res = result if seed == 0 else quickstart.run("cuda", seed=seed)
        for leaf in leaves(res.final_params):
            check(bool(torch.isfinite(leaf).all()),
                  f"seed {seed}: non-finite final params")
        check(res.records[-1].round == 80, f"seed {seed}: not 80 merges")
        best[seed] = res.best_acc
        print(f"quickstart seed {seed}: best accuracy {best[seed]:.4f} "
              f"(JAX {JAX_BEST_ACC[seed]:.4f})", flush=True)
    port_med = statistics.median(best.values())
    jax_med = statistics.median(JAX_BEST_ACC.values())
    print(f"median best accuracy over seeds 0-7: port {port_med:.4f}, "
          f"JAX {jax_med:.4f} (tolerance {ACC_TOL})", flush=True)
    check(abs(port_med - jax_med) <= ACC_TOL,
          f"median best accuracy {port_med} outside {jax_med}+-{ACC_TOL}")

    # sync rounds through the kernel vs through the plain version; with
    # cuDNN deterministic the two runs differ only in the merge
    sync = {}
    for impl in ("auto", "ref"):
        kernel.fed_agg_cuda.launches = 0
        sim = quickstart.make_simulation("cuda", policy="all", mode="sync",
                                         impl=impl)
        sync[impl] = (sim.run_sync(rounds=3), kernel.fed_agg_cuda.launches)
    (rk, nk), (rr, nr) = sync["auto"], sync["ref"]
    check([(r.time, r.round) for r in rk.records]
          == [(r.time, r.round) for r in rr.records],
          "sync time/round columns differ between kernel and plain merge")
    acc_gap = max(abs(a.acc - b.acc) for a, b in zip(rk.records, rr.records))
    check(acc_gap <= 0.01, f"sync accuracy gap {acc_gap} > 0.01")
    param_gap = max(float((a - b).abs().max()) for a, b in
                    zip(leaves(rk.final_params), leaves(rr.final_params)))
    rounds = rk.records[-1].round
    check(nk == rounds and nr == 0,
          f"sync launches: kernel run {nk} for {rounds} rounds, plain run {nr}")
    print(f"sync all-policy, {rounds} rounds: kernel vs plain merge "
          f"acc gap {acc_gap:.4g}, final params max |diff| {param_gap:.3g}, "
          f"{nk / rounds:.0f} fed_agg launch per round", flush=True)

    # 5. results
    main_row = next(r for r in rows if (r["K"], r["N"], r["dtype"])
                    == MAIN_SHAPE)
    print(json.dumps({"kernels": [{
        "name": "fed_agg", "route": "cuda",
        "source": "src/repro_torch/kernels/fed_agg/csrc/fed_agg.cu",
        "replaces": "src/repro/kernels/fed_agg/kernel.py:40",
        "launches": launches, "max_abs_err": main_row["max_abs_err"],
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

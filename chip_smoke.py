#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100).

  python3 chip_smoke.py

Phases, in order; any failure exits non-zero and nothing is caught:
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from src/repro_torch/kernels/*/csrc, one nvcc
     per source, all started together;
  3. hold fed_agg against its plain version, bit for bit, over K x N x
     dtype as groups of one leaf, with its time, the plain version's, one
     torch.einsum call's (a yardstick the port never calls) and the least
     time the card could take; then the grouped launch over whole trees
     (the async merge and a sync round over flight-cnn-mnist's 6 leaves,
     the paper suite's MLP at K = 10 and 2, the resume fleet's MLP at
     K = 5, the overhead bench's 10 x 2^20 and 8 x 2^18, a mixed fp32 /
     bf16 tree, K = 1, a tree at a launch's capacity and one member past
     it, which must be 2 launches), and the async merge timed
     beside an empty kernel (the launch floor) and as
     aggregation.async_merge's Python call;
  4. the quickstart path: the port's quickstart on the card (Alg. 2, async,
     80 merges, seed 0), which must launch fed_agg once a merge; the same
     run at seeds
     1-7, whose median best accuracy must be within 0.03 of the JAX
     quickstart's median over the same seeds; then a 3-round sync run
     twice, through the kernel and through the plain version, which must
     agree; one round of the same responses folded flat and through a
     2-cell fog tier (params within 1e-6), and the 3 rounds through the
     fog tier (accuracy within 0.01 of the flat run), 1 and 3 launches a
     round;
  5. the paper's experiment suite: repro_torch.examples.paper.run's main
     with fig12-fig18 and FedOpt at seed 0 (21 simulations; each summary
     line and each figure's wall time printed, the CSV written to
     artifacts/paper_suite_seed0.csv), which must launch fed_agg once per
     merge (sync rounds plus async merges, read from the records' server
     versions); the overhead bench's rows (fed_agg and quant8 on the card)
     beside the card's name and power limit; then fig18 at seeds 1-7, whose
     medians of the selection and async gains over seeds 0-7 must lie within
     FIG18_TOL of the JAX harness's medians (JAX_FIG18);
  6. crash-safe resume: the resume fleet (examples/resume.py, the JAX
     package's tests/test_resume.py run) killed at sync round 2 and at
     async merge 4, then resumed from its checkpoint: killed + resumed
     must equal the uninterrupted run's records and final params exactly,
     one fed_agg launch a merge;
  7. hold the grouped quant8 kernels (quantise, dequantise; one launch
     over a list of leaves) against their plain version, bit for bit:
     over C x rows x dtype with NaN/inf rows as groups of one, with their
     times, the plain version's, one `q * scale` call's and the bound;
     over mixed lists (every width, C = 5 beside 1,027, one-row and
     unaligned leaves, an odd 50,257-wide vocabulary row, a list longer
     than a launch's table, which must be ceil(n / capacity) launches);
     then time the five leaves of one P = 8 exchange as one grouped
     launch, as five single-leaf launches, through the plain version and
     as one torch.mul(q, s) a leaf (dequantise; a yardstick the port never
     calls), warm (inputs in L2) and cold (L2 flushed first), in CUDA-graph
     and Python-call time, beside the bound, and the same at granite-20b's
     int8 K/V cache shape (bf16);
  8. the exchange path: examples/fl_exchange at P = 2, 4, 8 in the modes
     f32, q8, topk and q8_topk, flat and two-tier, through the kernels and
     through the plain version (equal outputs; wire MB equal to the JAX
     benchmark's BENCH_exchange.json); one q8 exchange must be 2 quant8
     launches flat and 4 two-tier (one grouped quantise and dequantise a
     hop), a plain one 0; then 4 islands of flight-cnn-mnist, 3 rounds of
     one local epoch and a q8 exchange through 2 fog cells, through the
     kernels and the plain version, which must give equal final params;
  9. hold flash_attention against its plain version over
     tests/test_kernels.py's shapes, odd T (1, 77, 1,000, 4,097), D = 8,
     12, 16, 200, 256, windows off the tile grid, non-causal, fp32 and
     bf16 (3e-4 / 3e-2), and strided views on the mma.sync and FMA routes,
     printing each shape's route (kernel.route: wgmma for bf16 that TMA
     can describe, mma / fma for the rest); then time it at granite-20b's
     and recurrentgemma-9b's full-width prefill shapes beside the bound,
     the plain version and one scaled_dot_product_attention call (a
     yardstick the port never calls);
  10. the LM serving path at granite-20b's full width (20.32 B params,
     bf16, drawn on the card): `python -m repro_torch.launch.serve --full
     --batch 8 --prompt-len 2048 --gen 32` through its main, which must
     launch flash_attention once per layer (52), all on the wgmma route;
     then a batch of 2 x 2,048
     prefilled through the kernel, each layer's attention held against the
     plain version on the same q/k/v (3e-2), and again through the plain
     version: last-position logits within 2e-2 scale-relative;
  11. the continuous-batching ServeLoop at full width (4 slots, 4,096
     positions) draining 8 requests of 1 to 2,047 prompt tokens, 16 new
     tokens each: one flash launch per layer per admitted prefill, each
     first token equal to its solo prefill's; token agreement with solo
     generation is reported;
  12. hold linrec against its plain version, bit for bit, over
     tests/test_kernels.py's shapes, odd T (1, 77, 1,000) and odd D (12,
     130), with and without a starting state, fp32 and bf16, on each route
     that takes the shape (column always, tma where TMA can describe it),
     printing the route kernel.route picks; and time both routes at both
     recurrent models' prefill scans and a falcon decode step, in turns
     (the median of three readings a route), beside the bound and the plain version (no single PyTorch call
     computes it);
  13. falcon-mamba-7b at full width (7.27 B params, bf16, drawn on the
     card): `python -m repro_torch.launch.serve --arch falcon-mamba-7b
     --full --batch 4 --prompt-len 2048 --gen 32` through its main, which
     must launch linrec once per layer in the prefill (64, all on the tma
     route) and in each decode step (64, on the column route); then a batch of 2 x 2,048 prefilled through the
     kernel, each layer's scan held against the plain version on the same
     a, b (2e-4), and again through the plain version: last-position
     logits within 2e-2 scale-relative;
  14. falcon-mamba-7b in a full-width ServeLoop (4 slots) draining 8
     requests of 3 to 2,047 prompt tokens, 16 new tokens each: one linrec
     launch per layer per admitted prefill and per decode step, each first
     token equal to its solo prefill's; agreement with solo generation is
     reported;
  15. recurrentgemma-9b at full width (10.44 B params): `serve.py --arch
     recurrentgemma-9b --full --batch 2 --prompt-len 2048 --gen 32`, 26
     linrec and 12 flash launches (wgmma route) in the prefill and 26 linrec launches a
     decode step; then its 2 x 2,048 prefill's attention and scans held
     layer by layer against the plain versions, and its last-position
     logits against the plain run's: within 3.5e-2 (see LM_LOGITS_TOL);
  16. print the kernel table as JSON, then the result line.

Each model is freed before the next one is drawn (40.6, 14.6, then 20.9
GB of weights).
"""
from __future__ import annotations

import contextlib
import io
import json
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory (NVIDIA data sheet)
FP32_FLOPS_PER_S = 67e12     # H100 SXM fp32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12    # H100 SXM dense bf16 tensor cores
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
# one round's fog fold (cells, then the cloud) against the flat fold: the
# weighted mean re-associated, fp32 rounding apart; a wrong cell weighting
# moves it by the responses' spread, about 1e-2 here
FOG_FOLD_TOL = 1e-6
# the paper suite (repro_torch.examples.paper.run) at seed 0; the overhead
# bench runs after it, apart, so the figures' fed_agg launches are counted
# alone
PAPER_FIGURES = "fig12,fig13,fig14,fig15,fig16,fig17,fig18,fedopt"
PAPER_SIMS = 21             # simulations the figures run: 2+2+2+2+4+3+3+3
# fig18's (selection_gain, async_gain) of the JAX harness (benchmarks/
# fig18_async.py) on the CPU, per seed, as printed by
# `PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_paper.py`.
# Medians over the eight seeds are held; their tolerance is twice the
# largest shift of the JAX median when every initial param moves one ulp
# up or down (selection 0.0404, async 0.0119; PERF.md section 6).
JAX_FIG18 = {0: (-0.022147, 0.187297), 1: (-0.722277, 0.121167),
             2: (-2.425807, 0.033330), 3: (-2.215897, 0.288759),
             4: (-0.317154, 0.197151), 5: (-1.222383, -0.052547),
             6: (-0.872593, 0.057101), 7: (-1.317599, 0.002766)}
FIG18_TOL = {"selection_gain": 0.0807, "async_gain": 0.0238}
# quant8 sweep: row width C (5: odd; 256: the exchange's matrices; 1027:
# its bias; 4096; 151,936: an LM head's vocabulary row) x total elements
Q8_WIDTHS = (5, 256, 1027, 4096, 151_936)
Q8_ODD_VOCAB = 50_257              # a vocabulary row of no 16-byte multiple
Q8_TOTALS = (1 << 10, 1 << 14, 1 << 18, 1 << 22, 1 << 26)
Q8_OPS_PER_ELEMENT = {"quantize": 5, "dequantize": 1}   # abs, max, divide,
#                                  round, clamp; multiply (fp32, no tensor core)
EXCHANGE_P = 8                     # the exchange's leaf shapes at P islands
Q8_LONG_LIST = 70                  # leaves: more than two tables' capacity
L2_FLUSH_BYTES = 256 << 20         # read between cold calls: 5x the L2
# granite-20b's int8 decode cache as read_kv dequantises it: rows = batch
# x (prompt + models/cache.py's PREFILL_DECODE_MARGIN of 128) x 1 KV head
KV_READ_ROWS, KV_HEAD_DIM = 8 * (2048 + 128) * 1, 128
# flash_attention sweep (B, T, H, Hkv, D, window, causal): test_kernels.py's
# five shapes, odd T, the smoke configs' head dims, non-causal, then a tail
# tile of one key, D = 256 under a window off the tile grid, granite's group
# of 48; bf16 takes the wgmma kernel wherever D % 8 == 0 (D = 12: mma.sync)
FA_SWEEP = [(2, 256, 4, 4, 64, 0, True), (2, 256, 4, 2, 64, 0, True),
            (2, 512, 8, 1, 128, 0, True), (2, 512, 4, 2, 64, 128, True),
            (2, 1024, 2, 2, 64, 300, True), (2, 1, 48, 1, 128, 0, True),
            (2, 77, 48, 1, 128, 0, True), (1, 1000, 48, 1, 128, 0, True),
            (2, 77, 8, 2, 8, 0, True), (2, 100, 4, 4, 12, 0, True),
            (2, 130, 4, 1, 16, 0, True), (2, 77, 4, 2, 64, 0, False),
            (1, 300, 8, 8, 128, 0, False), (1, 130, 3, 3, 200, 50, False),
            (1, 300, 4, 1, 256, 0, True), (1, 4097, 4, 1, 128, 0, True),
            (2, 700, 4, 1, 256, 300, True), (1, 520, 48, 1, 128, 0, True)]
# bf16 q/k/v as views of one fused (B, T, 6, D + pad) projection, (D, pad,
# route): a row padded by 8 keeps TMA's strides; by 1, mma.sync (D <= 128)
# or the FMA kernel (D > 128) takes it
FA_STRIDED = [(128, 8, "wgmma"), (64, 1, "mma"), (200, 1, "fma")]
FA_TOL = {"float32": 3e-4, "bfloat16": 3e-2}    # tests/test_kernels.py
LM_ARCH = "granite-20b"
LM_BATCH, LM_PROMPT, LM_GEN = 8, 2048, 32
FA_MAIN = (LM_BATCH, LM_PROMPT, 48, 1, 128)     # its prefill attention
LM_CHECK_BATCH = 2      # plain-version prefill: fp32 scores, 1.6 GB a layer
# full-width last-position logits, kernels vs plain, scale-relative
# (tests/test_cache_spec.py's measure).  A random-weight recurrentgemma-9b
# carries one bf16 ulp in its first attention layer to about 3 % of its
# logits, so its kernels, each within one ulp of the plain version, sit
# there; its tolerance lies between that and the faults planted by
# src/repro_torch/examples/logits_gap.py (readings in PERF.md section 6).
LM_LOGITS_TOL = {"granite-20b": 2e-2, "falcon-mamba-7b": 2e-2,
                 "recurrentgemma-9b": 3.5e-2}
LOOP_LENGTHS = (1, 77, 300, 1000, 2047, 513, 64, 1500)
LOOP_SLOTS, LOOP_MAX_LEN, LOOP_NEW = 4, 4096, 16
# linrec sweep (B, T, D): test_kernels.py's three shapes, then odd T and D
LR_SWEEP = [(1, 128, 128), (2, 512, 640), (3, 256, 512), (2, 1, 130),
            (2, 77, 12), (1, 1000, 130), (3, 77, 4096), (2, 1000, 12)]
LR_TOL = {"float32": 2e-4, "bfloat16": 3e-2}    # tests/test_kernels.py
SSM_ARCH, SSM_BATCH = "falcon-mamba-7b", 4
HYBRID_ARCH, HYBRID_BATCH = "recurrentgemma-9b", 2
# the prefill scans of the two models, (B, T, D): falcon's D is d_inner x N
LR_MAIN = {SSM_ARCH: (SSM_BATCH, LM_PROMPT, 8192 * 16),
           HYBRID_ARCH: (HYBRID_BATCH, LM_PROMPT, 4096)}
SSM_LOOP_LENGTHS = (3, 77, 300, 1000, 2047, 513, 64, 1500)
# recurrentgemma-9b's prefill attention (B, T, H, Hkv, D, window)
FA_HYBRID = (HYBRID_BATCH, LM_PROMPT, 16, 1, 256, 2048)


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


def bound(nbytes: int, ops: int,
          flops_per_s: float = FP32_FLOPS_PER_S) -> tuple[float, str]:
    """Least time (ms) the card could take and what bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / flops_per_s * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def kernel_sweep(torch, np):
    from repro_torch.kernels.fed_agg.kernel import fed_agg_cuda
    from repro_torch.kernels.fed_agg.ref import fed_agg_2d_ref
    rows = []
    g = torch.Generator(device="cuda").manual_seed(0)
    rng = np.random.default_rng(0)
    for dtype in (torch.float32, torch.bfloat16):
        for K in (1, 2, 5, 8):
            for N in (128, 5_000, 20_490, 1 << 24):
                x = torch.randn(K, N, generator=g, device="cuda").to(dtype)
                w_host = rng.dirichlet([1.0] * K)   # by value to the kernel
                w = torch.as_tensor(w_host, dtype=torch.float32).cuda()
                got = fed_agg_cuda(x, w_host)
                want = fed_agg_2d_ref(x, w)
                torch.cuda.synchronize()
                check(torch.equal(got, want), f"fed_agg K={K} N={N} {dtype}"
                      " differs from ref.py")
                err = float((got.float() - want.float()).abs().max())
                wl = w.to(dtype)
                iters = 200 if N <= 20_490 else 20
                ms = graph_ms(torch, lambda: fed_agg_cuda(x, w_host), iters)
                plain = graph_ms(torch, lambda: fed_agg_2d_ref(x, w), iters)
                lib = graph_ms(torch, lambda: torch.einsum("kn,k->n", x, wl),
                               iters)
                call = eager_ms(torch, lambda: fed_agg_cuda(x, w_host), iters)
                b_ms, b_by = bound((K + 1) * N * x.element_size(), 2 * K * N)
                row = {"K": K, "N": N, "dtype": str(dtype).split(".")[-1],
                       "max_abs_err": err, "ms": ms,
                       "plain_ms": plain, "library_ms": lib,
                       "call_ms": call, "bound_ms": b_ms, "bound_by": b_by}
                rows.append(row)
                print(f"fed_agg K={K} N={N} {row['dtype']}: bit-equal, "
                      f"kernel={ms:.5f} ms "
                      f"plain={plain:.5f} ms einsum={lib:.5f} ms "
                      f"bound={row['bound_ms']:.5f} ms ({row['bound_by']}, "
                      f"{row['bound_ms'] / ms:.1%} of it) "
                      f"python call={call:.5f} ms", flush=True)
    return rows


def fed_agg_tree_sweep(torch, np):
    """The grouped kernel on the main path's merges, held bit for bit
    against the plain version and timed: the async merge (K = 2) and a
    sync round (K = 5) over flight-cnn-mnist's 6 leaves; the paper suite's
    merges over its MLP's 4 leaves (fig12's all-worker sync round, K = 10;
    fig18's async merge, K = 2), the resume fleet's sync round over its
    MLP (K = 5) and the overhead bench's two aggregations (10 x 2^20 and
    8 x 2^18 fp32); a mixed fp32 / bf16 tree, and a tree past a launch's
    capacity (its launches counted); beside them an empty kernel's graph
    time, the launch floor, and the async merge as the server calls it
    (`aggregation.async_merge`) in Python-call time.  -> the async merge's
    record."""
    from repro_torch import threefry
    from repro_torch.configs import get_config
    from repro_torch.core import aggregation
    from repro_torch.examples import resume
    from repro_torch.examples.paper import common
    from repro_torch.kernels.fed_agg import kernel as fa
    from repro_torch.kernels.fed_agg.ref import (fed_agg_2d_ref,
                                                 fed_agg_grouped_ref)
    from repro_torch.models import build_model
    from repro_torch.tree import leaves, tree_map
    rng = np.random.default_rng(1)
    model = build_model(get_config("flight-cnn-mnist"))
    cnn = model.init(threefry.key(0), torch.device("cuda"))

    def leaf_shapes(tree):
        return [(tuple(l.shape), l.dtype) for l in leaves(tree)]
    shapes = leaf_shapes(cnn)
    paper_mlp, resume_mlp = (leaf_shapes(build_model(cfg).init(
        threefry.key(0), torch.device("cuda"))) for cfg in (common.MLP,
                                                           resume.MLP))
    mixed = [((33, 7), torch.float32), ((130,), torch.bfloat16),
             ((4, 5, 6), torch.float32), ((2048,), torch.bfloat16),
             ((3, 1025), torch.float32)]

    def members(K, shapes):
        return [[torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(
            "cuda", dt) for s, dt in shapes] for _ in range(K)]

    def held(label, ms_, w, launches):
        before = fa.fed_agg_grouped_cuda.launches
        got = fa.fed_agg_grouped_cuda(ms_, w)
        n = fa.fed_agg_grouped_cuda.launches - before
        want = fed_agg_grouped_ref(ms_, w)
        torch.cuda.synchronize()
        check(n == launches, f"fed_agg {label}: {n} launches, expected "
              f"{launches}")
        err = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(got, want))
        for a, b in zip(got, want):
            check(torch.equal(a, b), f"fed_agg {label}: differs from ref.py")
        print(f"fed_agg grouped, {label}: {len(ms_)} members x "
              f"{len(ms_[0])} leaves, {n} launch(es), bit-equal", flush=True)
        return err

    slots, parts = fa.capacity()
    cases = [("async merge, flight-cnn-mnist", members(2, shapes), 1),
             ("sync round, flight-cnn-mnist", members(5, shapes), 1),
             ("fig12 sync round, paper MLP", members(10, paper_mlp), 1),
             ("fig18 async merge, paper MLP", members(2, paper_mlp), 1),
             ("resume sync round, its MLP", members(5, resume_mlp), 1),
             ("overhead aggregation, 10 x 2^20",
              members(10, [((1 << 20,), torch.float32)]), 1),
             ("overhead fed_agg, 8 x 2^18",
              members(8, [((1 << 18,), torch.float32)]), 1),
             ("mixed fp32/bf16 tree", members(3, mixed), 1),
             ("K = 1", members(1, mixed), 1),
             (f"capacity edge ({slots} slots)",
              members(slots // len(mixed), mixed), 1),
             ("one member past it", members(slots // len(mixed) + 1,
                                           mixed), 2)]
    errs = [held(label, ms_, rng.dirichlet([1.0] * len(ms_)), launches)
            for label, ms_, launches in cases]
    print(f"fed_agg capacity: {slots} member slots, {parts} leaves a launch",
          flush=True)

    merge = cases[0][1]
    w = [0.7, 0.3]
    w_dev = torch.tensor(w, dtype=torch.float32, device="cuda")
    n = sum(t.numel() for t in merge[0])
    ms = graph_ms(torch, lambda: fa.fed_agg_grouped_cuda(merge, w), 500)
    floor = graph_ms(torch, fa.empty_launch, 500)
    plain = graph_ms(torch, lambda: [fed_agg_2d_ref(torch.stack(
        [m[l].reshape(-1) for m in merge]), w_dev) for l in range(len(
            merge[0]))], 100)
    call = eager_ms(torch, lambda: fa.fed_agg_grouped_cuda(merge, w), 1000)
    floor_call = eager_ms(torch, fa.empty_launch, 1000)
    server = cnn
    worker = tree_map(lambda p: p + 0.01, cnn)
    merge_call = eager_ms(torch, lambda: aggregation.async_merge(
        server, worker, 0.3), 1000)
    b_ms, b_by = bound(3 * n * 4, 4 * n)
    rec = {"max_abs_err": errs[0], "ms": ms, "plain_ms": plain,
           "floor_ms": floor, "call_ms": call, "floor_call_ms": floor_call,
           "async_merge_call_ms": merge_call, "bound_ms": b_ms,
           "bound_by": b_by}
    print(f"fed_agg async merge of flight-cnn-mnist's tree (K = 2, 6 leaves,"
          f" {n} fp32): one grouped launch {ms * 1e3:.3f} us (graph), empty "
          f"kernel {floor * 1e3:.3f} us (the launch floor), plain "
          f"{plain * 1e3:.3f} us, bound {b_ms * 1e3:.4f} us ({b_by}); a "
          f"Python call {call * 1e3:.2f} us (empty launch "
          f"{floor_call * 1e3:.2f} us), aggregation.async_merge "
          f"{merge_call * 1e3:.2f} us a call", flush=True)
    return rec


def poisoned_rows(torch, R: int, C: int, dtype, seed: int):
    """(R, C) normal rows over four decades of scale on the card; rows 0-3
    (as far as there are rows) hold a NaN, a +inf, a -inf, zeros only."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(R, C, generator=g, device="cuda")
    x *= 10.0 ** (torch.rand(R, 1, generator=g, device="cuda") * 4 - 2)
    for r, (c, v) in enumerate([(C // 2, float("nan")), (C - 1, float("inf")),
                                (0, float("-inf"))][:R]):
        x[r, c] = v
    if R > 3:
        x[3] = 0.0
    return x.to(dtype)


def near_tie_rows(torch, R: int, C: int, seed: int):
    """(R, C) fp32 rows whose quotients x / scale fall within 2^-16 of a
    half-integer (the ties rint breaks to even): column 0 holds 127 s, the
    rest (k + 0.5 + d 2^-22) s for integers |k| < 127, |d| <= 64, with one
    s = 10^U(-3, 3) a row."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    s = 10.0 ** (torch.rand(R, 1, generator=g, device="cuda") * 6 - 3)
    k = torch.randint(-126, 126, (R, C), generator=g, device="cuda")
    d = torch.randint(-64, 65, (R, C), generator=g, device="cuda")
    x = (k + 0.5 + d * 2.0 ** -22) * s
    x[:, 0] = 127 * s[:, 0]
    return x


def quant8_row(torch, x, out_dtype, *, check_nonfinite: bool):
    """Hold both quant8 kernels against their plain version on x (R, C),
    bit for bit, and time them; -> one record per kernel."""
    from repro_torch.kernels.quant8 import kernel as q8
    from repro_torch.kernels.quant8.ref import (dequantize_rows_ref,
                                                quantize_rows_ref)
    R, C = x.shape
    q, s = q8.quantize_rows_cuda(x)
    qr, sr = quantize_rows_ref(x)
    out = q8.dequantize_rows_cuda(q, s, out_dtype)
    outr = dequantize_rows_ref(q, s, out_dtype)
    torch.cuda.synchronize()
    check(torch.equal(q, qr), f"quant8 q differs from ref.py at {R}x{C}")
    torch.testing.assert_close(s, sr, rtol=0, atol=0, equal_nan=True)
    torch.testing.assert_close(out, outr, rtol=0, atol=0, equal_nan=True)
    if check_nonfinite:
        bad = min(R, 3)
        check(not q[:bad].any() and not torch.isfinite(s[:bad]).any(),
              f"quant8 NaN/inf rows at {R}x{C}: q not 0 or scale finite")
    q_err = int((q.int() - qr.int()).abs().max())
    fin = torch.isfinite(outr)
    d_err = float((out.float() - outr.float())[fin].abs().max()) \
        if fin.any() else 0.0
    iters = 200 if R * C <= 1 << 18 else 20
    n, itemsize, out_size = R * C, x.element_size(), out.element_size()
    recs = {}
    for name, kern, plain, lib, nbytes in (
            ("quantize", lambda: q8.quantize_rows_cuda(x),
             lambda: quantize_rows_ref(x), None,
             n * itemsize + n + 4 * R),
            ("dequantize", lambda: q8.dequantize_rows_cuda(q, s, out_dtype),
             lambda: dequantize_rows_ref(q, s, out_dtype),
             (lambda: torch.mul(q, s)) if out_dtype == torch.float32
             else None,
             n + 4 * R + n * out_size)):
        b_ms, b_by = bound(nbytes, Q8_OPS_PER_ELEMENT[name] * n)
        recs[name] = {
            "rows": R, "C": C, "dtype": str(x.dtype).split(".")[-1],
            "max_abs_err": q_err if name == "quantize" else d_err,
            "ms": graph_ms(torch, kern, iters),
            "plain_ms": graph_ms(torch, plain, iters),
            "library_ms": None if lib is None else graph_ms(torch, lib,
                                                             iters),
            "call_ms": eager_ms(torch, kern, iters),
            "bound_ms": b_ms, "bound_by": b_by}
    return recs


def quant8_sweep(torch):
    """Rows of C x total elements x dtype, each with NaN/inf rows."""
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for C in Q8_WIDTHS:
            for R in dict.fromkeys(max(1, t // C) for t in Q8_TOTALS):
                x = poisoned_rows(torch, R, C, dtype, seed=R * C)
                rec = quant8_row(torch, x, dtype, check_nonfinite=True)
                rows.append(rec)
                qz, dq = rec["quantize"], rec["dequantize"]
                lib = "-" if dq["library_ms"] is None \
                    else f"{dq['library_ms'] * 1e3:.2f}"
                print(f"quant8 C={C} rows={R} {qz['dtype']}: quantize "
                      f"{qz['ms'] * 1e3:.2f} us (plain "
                      f"{qz['plain_ms'] * 1e3:.2f}, bound "
                      f"{qz['bound_ms'] * 1e3:.2f} {qz['bound_by']}, "
                      f"{qz['bound_ms'] / qz['ms']:.1%}) | dequantize "
                      f"{dq['ms'] * 1e3:.2f} us (plain "
                      f"{dq['plain_ms'] * 1e3:.2f}, q*s {lib}, bound "
                      f"{dq['bound_ms'] * 1e3:.2f}, "
                      f"{dq['bound_ms'] / dq['ms']:.1%}); bit-equal, "
                      "NaN/inf rows q=0", flush=True)
                del x
    return rows


def quant8_mixed_lists(torch):
    """The grouped kernels over mixed leaf lists, bit for bit against the
    plain version: quotients near rint's ties, every width of Q8_WIDTHS in
    one list, C = 5 beside
    1,027, a one-row leaf, the int8 cache's 128, leaves starting off a
    16-byte boundary, NaN/inf rows, in both dtypes; then a list of
    Q8_LONG_LIST leaves, more than one table holds, which must be
    ceil(n / capacity) launches of each kernel."""
    from repro_torch.kernels.quant8 import kernel as q8
    from repro_torch.kernels.quant8.ref import (dequantize_rows_grouped_ref,
                                                quantize_rows_grouped_ref)

    def held(xs, out_dtype, label):
        qss = q8.quantize_grouped_cuda(xs)
        outs = q8.dequantize_grouped_cuda([q for q, _ in qss],
                                          [s for _, s in qss], out_dtype)
        want_q = quantize_rows_grouped_ref(xs)
        want_o = dequantize_rows_grouped_ref([q for q, _ in qss],
                                             [s for _, s in qss], out_dtype)
        torch.cuda.synchronize()
        for x, (q, s), (qr, sr), o, orf in zip(xs, qss, want_q, outs,
                                               want_o):
            check(torch.equal(q, qr), f"quant8 grouped q differs from "
                  f"ref.py at {tuple(x.shape)} in {label}")
            torch.testing.assert_close(s, sr, rtol=0, atol=0, equal_nan=True)
            torch.testing.assert_close(o, orf, rtol=0, atol=0,
                                       equal_nan=True)
        print(f"quant8 grouped {label}: {len(xs)} leaves "
              f"{[tuple(x.shape) for x in xs]}, bit-equal", flush=True)

    ties = [near_tie_rows(torch, 4096, C, seed=C) for C in (5, 256, 1027)]
    held(ties, torch.float32, "float32 quotients near ties of rint")
    shapes = [(R, C) for C in Q8_WIDTHS for R in (1, 4, max(1, 4096 // C))]
    shapes += [(64, 5), (9, 1027), (1, 5), (700, 128)]
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        xs = [poisoned_rows(torch, R, C, dtype, seed=i)
              for i, (R, C) in enumerate(shapes)]
        held(xs, dtype, f"{name} widths {Q8_WIDTHS} and odd rows")
        flat = poisoned_rows(torch, 4, 3 * 1024 + 64, dtype, seed=99)
        flat = flat.reshape(-1)
        wide = poisoned_rows(torch, 4, Q8_WIDTHS[-1] + 1, dtype,
                             seed=98).reshape(-1)
        held([flat[1:1 + 3 * 1024].reshape(3, 1024),
              flat[2:2 + 5 * 256].reshape(5, 256), xs[0],
              wide[1:1 + 3 * Q8_WIDTHS[-1]].reshape(3, Q8_WIDTHS[-1]),
              poisoned_rows(torch, 3, Q8_ODD_VOCAB, dtype, seed=97)], dtype,
             f"{name} leaves off 16-byte boundaries, an odd vocabulary")
    cap = q8.capacity()
    xs = [poisoned_rows(torch, 1 + i % 6, (5, 256, 1027, 128)[i % 4],
                        torch.float32, seed=1000 + i)
          for i in range(Q8_LONG_LIST)]
    before = (q8.quantize_grouped_cuda.launches,
              q8.dequantize_grouped_cuda.launches)
    held(xs, torch.float32, f"list of {len(xs)} (capacity {cap})")
    n = (q8.quantize_grouped_cuda.launches - before[0],
         q8.dequantize_grouped_cuda.launches - before[1])
    want = -(-len(xs) // cap)
    check(n == (want, want), f"quant8 list of {len(xs)}: launches {n}, "
          f"expected {want} each")
    print(f"quant8 list of {len(xs)} leaves: {n[0]} launches of each "
          "kernel", flush=True)


def cold_graph_ms(torch, fn, iters: int, flush) -> float:
    """Device time of one call that finds its inputs out of L2: `iters`
    (flush, call) pairs in one CUDA graph, less the flushes alone; the
    flush reads a buffer larger than L2 (clean lines, nothing to write
    back)."""
    return graph_ms(torch, lambda: (flush(), fn()), iters) - \
        graph_ms(torch, flush, iters)


def quant8_group_record(torch, label, xs, out_dtype, flush):
    """Both kernels over the leaf list xs, held bit for bit and timed three
    ways: one grouped call, one call per leaf, the plain version; each in
    CUDA-graph time warm (inputs in L2) and cold (L2 flushed first), and
    as issued from Python; for an fp32 dequantise also PyTorch's
    `torch.mul(q, s)` a leaf (the same function, bit for bit); -> one
    record per kernel."""
    from repro_torch.kernels.quant8 import kernel as q8
    from repro_torch.kernels.quant8.ref import (dequantize_rows_grouped_ref,
                                                quantize_rows_grouped_ref)
    qss = q8.quantize_grouped_cuda(xs)
    qs, ss = [q for q, _ in qss], [s for _, s in qss]
    outs = q8.dequantize_grouped_cuda(qs, ss, out_dtype)
    want = quantize_rows_grouped_ref(xs)
    want_o = dequantize_rows_grouped_ref(qs, ss, out_dtype)
    torch.cuda.synchronize()
    q_err, d_err = 0, 0.0
    for (q, s), (qr, sr), o, orf in zip(qss, want, outs, want_o):
        check(torch.equal(q, qr), f"quant8 {label}: q differs from ref.py")
        torch.testing.assert_close(s, sr, rtol=0, atol=0, equal_nan=True)
        torch.testing.assert_close(o, orf, rtol=0, atol=0, equal_nan=True)
        q_err = max(q_err, int((q.int() - qr.int()).abs().max()))
        d_err = max(d_err, float((o.float() - orf.float()).abs().max()))
    n = sum(x.numel() for x in xs)
    R = sum(x.shape[0] for x in xs)
    in_size, out_size = xs[0].element_size(), outs[0].element_size()
    recs = {}
    mul = None
    if out_dtype == torch.float32:
        mul = lambda: [torch.mul(q, s) for q, s in zip(qs, ss)]
        for (q, s), o in zip(zip(qs, ss), outs):
            torch.testing.assert_close(torch.mul(q, s), o, rtol=0, atol=0,
                                       equal_nan=True)
    for name, grouped, singles, plain, library, nbytes, err in (
            ("quantize", lambda: q8.quantize_grouped_cuda(xs),
             lambda: [q8.quantize_rows_cuda(x) for x in xs],
             lambda: quantize_rows_grouped_ref(xs), None,
             n * in_size + n + 4 * R, q_err),
            ("dequantize",
             lambda: q8.dequantize_grouped_cuda(qs, ss, out_dtype),
             lambda: [q8.dequantize_rows_cuda(q, s, out_dtype)
                      for q, s in zip(qs, ss)],
             lambda: dequantize_rows_grouped_ref(qs, ss, out_dtype), mul,
             n + 4 * R + n * out_size, d_err)):
        b_ms, b_by = bound(nbytes, Q8_OPS_PER_ELEMENT[name] * n)
        rec = {"leaves": len(xs), "rows": R, "elements": n,
               "max_abs_err": err, "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": None, "library_cold_ms": None}
        ways = [("grouped", grouped), ("single", singles), ("plain", plain)]
        for way, fn in ways + ([("library", library)] if library else []):
            rec[f"{way}_ms"] = graph_ms(torch, fn, 50)
            rec[f"{way}_cold_ms"] = cold_graph_ms(torch, fn, 20, flush)
            rec[f"{way}_call_ms"] = eager_ms(torch, fn, 200)
        recs[name] = rec
        print(f"quant8 {name} over {label} ({len(xs)} leaves, {R} rows, {n} "
              f"elements, {nbytes / 1e6:.3f} MB): one grouped launch "
              f"{rec['grouped_cold_ms'] * 1e3:.3f} us cold "
              f"({b_ms / rec['grouped_cold_ms']:.1%} of the bound), "
              f"{rec['grouped_ms'] * 1e3:.3f} us warm (L2), "
              f"{rec['grouped_call_ms'] * 1e3:.3f} us a Python call | "
              f"{len(xs)} single-leaf launches "
              f"{rec['single_cold_ms'] * 1e3:.3f} us cold, "
              f"{rec['single_ms'] * 1e3:.3f} us warm, "
              f"{rec['single_call_ms'] * 1e3:.3f} us in Python calls | plain "
              f"{rec['plain_cold_ms'] * 1e3:.3f} us cold, "
              f"{rec['plain_ms'] * 1e3:.3f} us warm, "
              f"{rec['plain_call_ms'] * 1e3:.3f} us in Python | "
              + ("" if rec["library_ms"] is None else
                 f"torch.mul(q, s) a leaf {rec['library_cold_ms'] * 1e3:.3f}"
                 f" us cold, {rec['library_ms'] * 1e3:.3f} us warm, "
                 f"{rec['library_call_ms'] * 1e3:.3f} us in Python | ")
              + f"bound {b_ms * 1e3:.3f} us ({b_by}); bit-equal", flush=True)
    return recs


def quant8_exchange_shapes(torch):
    """Both kernels at the five leaf shapes one flat q8 exchange of P = 8
    islands hands them (the fp32 deltas, rows = P x leading dims), as one
    group; then K and V of granite-20b's int8 decode cache read as one
    group (bf16 out).  -> the exchange's records, by kernel."""
    from repro_torch.examples import fl_exchange
    stacked, base = fl_exchange.make_tree(EXCHANGE_P, device="cuda")
    xs = []
    for name in sorted(stacked):
        delta = stacked[name].float() - base[name].float()
        xs.append(delta.reshape(-1, delta.shape[-1]).contiguous())
    big = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")
    big.normal_()
    total = torch.empty((), device="cuda")
    flush = lambda: torch.sum(big, dim=0, out=total)
    recs = quant8_group_record(torch, f"one P={EXCHANGE_P} exchange", xs,
                               torch.float32, flush)
    g = torch.Generator(device="cuda").manual_seed(0)
    kv = [(torch.randn(KV_READ_ROWS, KV_HEAD_DIM, generator=g,
                       device="cuda") * 0.5).to(torch.bfloat16)
          for _ in range(2)]
    quant8_group_record(
        torch, f"{LM_ARCH}'s int8 K/V cache, bf16 in and out ("
        f"{KV_READ_ROWS} x {KV_HEAD_DIM} each)", kv, torch.bfloat16, flush)
    return recs


def exchange_path(torch):
    """The exchange entry point at P = 2, 4, 8 x 4 modes, flat and
    two-tier, through the kernels; -> the per-cell outputs for the plain
    comparison."""
    from repro_torch.examples import fl_exchange
    committed = json.loads((ROOT / "BENCH_exchange.json").read_text())
    outputs = {}
    for fog_cells in (1, 2):
        cells, outs = fl_exchange.run("cuda", fog_cells=fog_cells)
        parity = fl_exchange.measure_parity("cuda", fog_cells=fog_cells)
        bad = fl_exchange.check_invariants(cells, parity)
        check(not bad, f"fl_exchange invariants: {bad}")
        tier = "flat" if fog_cells == 1 else f"{fog_cells} fog cells"
        for name, c in cells.items():
            want = committed["cells"][name]["wire_mb_per_round"]
            check(c["wire_mb_per_round"] == want,
                  f"{name}: wire {c['wire_mb_per_round']} MB != {want}")
            print(f"fl_exchange {tier} P={c['islands']} {c['mode']}: "
                  f"{c['wire_mb_per_round']} MB/round (benchmark {want}), "
                  f"{c['reduction_vs_f32']}x vs f32, "
                  f"{c['exchange_ms']:.4f} ms/exchange (CUDA events)",
                  flush=True)
        print(f"fl_exchange {tier}: parity {parity}", flush=True)
        outputs[fog_cells] = outs
    return outputs


def attention_pairs(T: int, window: int, causal: bool) -> int:
    """(query, key) pairs the mask leaves live, S == T."""
    t = np.arange(T)
    lo = np.maximum(t - window + 1, 0) if window else np.zeros_like(t)
    hi = t + 1 if causal else np.full_like(t, T)
    return int((hi - lo).sum())


def flash_sweep(torch):
    """flash_attention vs its plain version over FA_SWEEP x dtype and the
    FA_STRIDED views, each on the route kernel.route gives it; then the
    two full-width prefill shapes, timed; -> their records, by arch."""
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_cuda, route
    from repro_torch.kernels.flash_attention.ref import attention_ref
    F = torch.nn.functional
    g = torch.Generator(device="cuda").manual_seed(0)

    def qkv(B, T, H, Hkv, D, dtype):
        q = torch.randn(B, T, H, D, generator=g, device="cuda") * 0.3
        k = torch.randn(B, T, Hkv, D, generator=g, device="cuda") * 0.3
        v = torch.randn(B, T, Hkv, D, generator=g, device="cuda")
        return q.to(dtype), k.to(dtype), v.to(dtype)

    def plain(q, k, v, window=0, causal=True):
        return attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), causal=causal,
                             window=window).transpose(1, 2)

    def held(name, label, q, k, v, window, causal):
        got = flash_attention_cuda(q, k, v, causal=causal, window=window)
        want = plain(q, k, v, window, causal)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        check(err <= FA_TOL[name] and bool(torch.isfinite(got).all()),
              f"flash_attention {name} {label}: max |diff| {err} > "
              f"{FA_TOL[name]}")
        print(f"flash_attention {name} {label} route {route(q, k, v)}: max "
              f"|diff| {err:.3g} (tol {FA_TOL[name]})", flush=True)

    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for B, T, H, Hkv, D, window, causal in FA_SWEEP:
            q, k, v = qkv(B, T, H, Hkv, D, dtype)
            want_route = "fma" if dtype == torch.float32 else \
                "wgmma" if D % 8 == 0 else "mma"
            check(route(q, k, v) == want_route, f"flash_attention {name} D="
                  f"{D}: route {route(q, k, v)}, expected {want_route}")
            held(name, f"B={B} T={T} H={H} Hkv={Hkv} D={D} window={window} "
                 f"causal={causal}", q, k, v, window, causal)
    for D, pad, want_route in FA_STRIDED:
        x = torch.randn(2, 300, 6, D + pad, generator=g, device="cuda")
        x = (x * 0.3).to(torch.bfloat16)[..., :D]
        q, k, v = x[:, :, :4], x[:, :, 4:5], x[:, :, 5:6]
        check(route(q, k, v) == want_route, f"flash_attention strided D={D}"
              f": route {route(q, k, v)}, expected {want_route}")
        held("bfloat16", f"strided views D={D} (rows of {D + pad}) "
             "window=100", q, k, v, 100, True)
    recs = {}
    for arch, (B, T, H, Hkv, D, window) in (
            (LM_ARCH, (*FA_MAIN, 0)), (HYBRID_ARCH, FA_HYBRID)):
        q, k, v = qkv(B, T, H, Hkv, D, torch.bfloat16)
        check(route(q, k, v) == "wgmma", f"{arch} prefill attention route "
              f"{route(q, k, v)}")
        got = flash_attention_cuda(q, k, v, window=window)
        err = float((got.float() - plain(q, k, v, window).float()).abs().max())
        check(err <= FA_TOL["bfloat16"], f"flash_attention {arch} full "
              f"width: {err}")
        del got
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        ms = graph_ms(torch, lambda: flash_attention_cuda(q, k, v,
                                                          window=window), 5)
        plain_ms = graph_ms(torch, lambda: plain(q, k, v, window), 2)
        # the yardstick: is_causal=True is recurrentgemma's window of 2,048
        # at T = 2,048 (every key j <= t also has j > t - 2,048)
        check(window in (0, T), f"no SDPA mask for window {window}")
        lib_ms = graph_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), 20)
        flops = 4 * D * attention_pairs(T, window, True) * B * H
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
        b_ms, b_by = bound(nbytes, flops, BF16_FLOPS_PER_S)
        # P kept as hi + lo bf16 doubles the P V half of the tensor work
        split_ms, _ = bound(nbytes, flops * 3 // 2, BF16_FLOPS_PER_S)
        recs[arch] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      "library_ms": lib_ms, "bound_ms": b_ms,
                      "bound_by": b_by}
        print(f"flash_attention {arch} full width B={B} T={T} H={H} Hkv={Hkv}"
              f" D={D} window={window} bf16 causal, route wgmma: {ms:.4f} ms "
              f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, "
              f"sdpa {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; "
              f"{flops:.4g} FLOPs, {nbytes / 1e9:.3f} GB; {b_ms / ms:.2%} of "
              f"it), with P split {split_ms:.4f} ms ({split_ms / ms:.2%} of "
              f"it), max |diff| {err:.3g}", flush=True)
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    return recs


def layer_counts(cfg) -> dict:
    """Launches of each kernel in one prefill of `cfg`'s model: flash for
    every attention layer, linrec for every recurrent (SSM, RG-LRU) one."""
    if cfg.family == "ssm":
        return {"flash_attention": 0, "linrec": cfg.num_layers}
    if cfg.family == "hybrid":
        from repro_torch.models.rglru import hybrid_counts
        n_super, n_tail = hybrid_counts(cfg)
        return {"flash_attention": n_super, "linrec": 2 * n_super + n_tail}
    return {"flash_attention": cfg.num_layers, "linrec": 0}


def decode_counts(cfg) -> dict:
    """Launches of each kernel in one decode step: linrec per recurrent
    layer; attention decodes without flash."""
    return {"flash_attention": 0, "linrec": layer_counts(cfg)["linrec"]}


def lm_serve(torch, arch: str, batch: int):
    """The serve entry point at full width, counted from zero; -> (its
    result, the launches of each kernel in that run, peak memory)."""
    from repro_torch.launch import serve
    torch.cuda.reset_peak_memory_stats()
    for fn in serve.KERNELS.values():
        fn.launches = 0
        fn.routes.update(dict.fromkeys(fn.routes, 0))
    routes = serve.KERNELS["flash_attention"].routes
    lr_routes = serve.KERNELS["linrec"].routes
    t0 = time.perf_counter()
    res = serve.main(["--arch", arch, "--full", "--batch", str(batch),
                      "--prompt-len", str(LM_PROMPT), "--gen", str(LM_GEN)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in serve.KERNELS.items()}
    peak = torch.cuda.max_memory_allocated() / 1e9
    model = res["model"]
    steps = res["decode_steps"]
    per_prefill, per_step = layer_counts(model.cfg), decode_counts(model.cfg)
    for name, n in launches.items():
        got = (res["launches"]["prefill"][name],
               res["launches"]["decode"][name], n)
        want = (per_prefill[name], per_step[name] * steps,
                per_prefill[name] + per_step[name] * steps)
        check(got == want, f"serve {arch} --full: {name} launches (prefill,"
              f" {steps} decode steps, run) {got}, expected {want}")
    check(routes["wgmma"] == launches["flash_attention"]
          and sum(routes.values()) == routes["wgmma"],
          f"serve {arch} --full: flash launches by route {routes}; every one "
          "should take wgmma")
    # every prefill scan on the TMA kernel, every decode step's on the
    # column kernel
    want_lr = {"tma": per_prefill["linrec"],
               "column": per_step["linrec"] * steps}
    check(lr_routes == want_lr, f"serve {arch} --full: linrec launches by "
          f"route {lr_routes}, expected {want_lr}")
    toks = res["tokens"]
    check(toks.shape == (batch, LM_GEN) and toks.min() >= 0
          and toks.max() < model.cfg.vocab_size,
          f"serve {arch} --full: generated ids {toks.shape}, range "
          f"{toks.min()}..{toks.max()}")
    pre, dec = res["prefill_s"], res["decode_s"]
    print(f"serve {arch} full width ({model.n_params / 1e9:.2f} B params,"
          f" bf16; drawn on the card in {res['init_s']:.1f} s): prefill "
          f"{batch}x{LM_PROMPT} {pre * 1e3:.1f} ms "
          f"({batch * LM_PROMPT / pre:.0f} tok/s), decode "
          f"{dec * 1e3 / steps:.2f} ms/step ({batch * steps / dec:.0f} "
          f"tok/s), launches {launches} ({per_prefill} in the prefill, "
          f"{per_step} per decode step; flash by route {routes}, linrec by "
          f"route {lr_routes}), peak memory"
          f" {peak:.2f} GB, "
          f"{wall:.1f} s wall", flush=True)
    return res, launches, peak


def lm_kernel_vs_plain(torch, model, params):
    """A batch of LM_CHECK_BATCH x LM_PROMPT prefilled through the kernels,
    each layer's attention and scan output held against the plain version
    on the same inputs, then the whole prefill through the plain versions:
    last-position logits within the arch's LM_LOGITS_TOL."""
    from repro_torch.kernels.linrec import ops as linrec_ops
    from repro_torch.models import layers
    arch = model.cfg.name
    rng = np.random.default_rng(1)
    toks = torch.as_tensor(rng.integers(
        0, model.cfg.vocab_size, (LM_CHECK_BATCH, LM_PROMPT)).astype(
            np.int32), device="cuda")
    select, scan = layers.select_attention, linrec_ops.linrec
    errs = {"flash_attention": [], "linrec": []}

    def checked_attention(q, k, v, **kw):
        out = select(q, k, v, **kw)
        want = select(q, k, v, **{**kw, "impl": "ref"})
        errs["flash_attention"].append(
            float((out.float() - want.float()).abs().max()))
        return out

    def checked_scan(a, b, h0=None, *, impl="auto"):
        out = scan(a, b, h0, impl=impl)
        want = scan(a, b, h0, impl="ref")
        errs["linrec"].append(float((out - want).abs().max()))
        return out

    layers.select_attention, linrec_ops.linrec = checked_attention, \
        checked_scan
    try:
        with torch.no_grad():
            lk, _ = model.apply(params, {"tokens": toks}, mode="prefill")
    finally:
        layers.select_attention, linrec_ops.linrec = select, scan
    tols = {"flash_attention": FA_TOL["bfloat16"],
            "linrec": LR_TOL["float32"]}
    with torch.no_grad():
        lr, _ = model.apply(params, {"tokens": toks}, mode="prefill",
                            impl="ref")
    counts = layer_counts(model.cfg)
    lk, lr = lk[:, -1].float(), lr[:, -1].float()
    rel = float((lk - lr).abs().max() / lr.abs().max())
    rms = float((lk - lr).pow(2).mean().sqrt() / lr.pow(2).mean().sqrt())
    agree = int((lk.argmax(-1) == lr.argmax(-1)).sum())
    logits_tol = LM_LOGITS_TOL[arch]
    layer_errs = {name: max(errs[name], default=float("nan"))
                  for name, n in counts.items() if n}
    per_layer = "; ".join(
        f"{name} vs plain per layer max |diff| {err:.3g} "
        f"({len(errs[name])} layers, tol {tols[name]})"
        for name, err in layer_errs.items())
    print(f"{arch} full width, {LM_CHECK_BATCH}x{LM_PROMPT} prefill: "
          f"{per_layer}; last-position logits scale-relative max |diff| "
          f"{rel:.3g}, rms |diff| / rms {rms:.3g}, tol {logits_tol:.3g}; "
          f"greedy agreement {agree}/{LM_CHECK_BATCH}", flush=True)
    for name, n in counts.items():
        e = errs[name]
        check(len(e) == n and max(e, default=0.0) <= tols[name],
              f"{arch}: per-layer {name} vs plain: {len(e)} layers "
              f"(expected {n}), max |diff| {max(e, default=0.0)}")
    check(bool(torch.isfinite(lk).all() and torch.isfinite(lr).all()),
          "non-finite prefill logits")
    check(rel <= logits_tol, f"{arch} prefill logits, kernels vs plain: "
          f"scale-relative max |diff| {rel} > {logits_tol}")
    return {"layer_max_abs_err": layer_errs, "logits_rel": rel}


def lm_serve_loop(torch, model, params, lengths):
    """ServeLoop at full width, counted from zero; -> the launches of each
    kernel in that run."""
    from repro_torch.launch import serve
    from repro_torch.launch.serve_loop import Request, ServeLoop
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    arch = model.cfg.name
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, model.cfg.vocab_size, n).astype(np.int32)
               for n in lengths]
    for fn in serve.KERNELS.values():
        fn.launches = 0
        fn.routes.update(dict.fromkeys(fn.routes, 0))
    routes = serve.KERNELS["flash_attention"].routes
    t0 = time.perf_counter()
    loop = ServeLoop(model, params, max_batch=LOOP_SLOTS,
                     max_len=LOOP_MAX_LEN)
    for i, p in enumerate(prompts):
        loop.submit(Request(rid=i, prompt=p, max_new=LOOP_NEW))
    done = {r.rid: r.out for r in loop.run_until_drained()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in serve.KERNELS.items()}
    check(sorted(done) == list(range(len(prompts)))
          and all(len(o) == LOOP_NEW for o in done.values()),
          f"ServeLoop: {len(done)} requests done, lengths "
          f"{[len(o) for o in done.values()]}")
    per_prefill, per_step = layer_counts(model.cfg), decode_counts(model.cfg)
    want = {name: per_prefill[name] * len(prompts)
            + per_step[name] * loop.decode_steps for name in launches}
    check(launches == want, f"ServeLoop {arch}: launches {launches} for "
          f"{len(prompts)} prefills and {loop.decode_steps} decode steps, "
          f"expected {want}")
    check(routes["wgmma"] == launches["flash_attention"],
          f"ServeLoop {arch}: flash launches by route {routes}")
    check(sorted(loop.free) == list(range(LOOP_SLOTS)), "slots not freed")
    print(f"ServeLoop {arch} full width, {LOOP_SLOTS} slots x "
          f"{LOOP_MAX_LEN}: {len(prompts)} requests (prompts {lengths}) x "
          f"{LOOP_NEW} tokens in {wall:.2f} s "
          f"({len(prompts) * LOOP_NEW / wall:.1f} tok/s), "
          f"{loop.decode_steps} decode steps, launches {launches} (linrec by "
          f"route {serve.KERNELS['linrec'].routes})", flush=True)
    prefill, decode = make_prefill_step(model), make_decode_step(model)
    first_equal, agree = 0, 0
    for i, p in enumerate(prompts):
        nxt, cache = prefill(params, {"tokens": torch.as_tensor(
            p[None], device="cuda")})
        solo = [int(nxt[0])]
        for pos in range(len(p), len(p) + LOOP_NEW - 1):
            nxt, cache = decode(params, {
                "tokens": nxt[:, None],
                "positions": torch.full((1, 1), pos, dtype=torch.int32,
                                        device="cuda")}, cache)
            solo.append(int(nxt[0]))
        first_equal += solo[0] == done[i][0]
        agree += sum(a == b for a, b in zip(solo, done[i]))
        del cache
    check(first_equal == len(prompts), f"ServeLoop {arch}: {first_equal} of "
          f"{len(prompts)} first tokens equal their solo prefill's")
    print(f"ServeLoop {arch} vs solo generation: first tokens {first_equal}/"
          f"{len(prompts)} equal; {agree}/{len(prompts) * LOOP_NEW} tokens "
          "agree (bf16 near-ties may flip across batch sizes; reported, "
          "not pinned)", flush=True)
    return launches


def linrec_sweep(torch):
    """linrec vs its plain version over LR_SWEEP x dtype x (zero, random
    h0), bit for bit, on each route that takes the shape (column always,
    tma where TMA can describe it), printing the route kernel.route picks;
    then both models' prefill scans and a falcon decode step, timed on
    both routes; -> the records of the timed shapes, by name."""
    from repro_torch.kernels.linrec.kernel import linrec_cuda, route, tma_ok
    from repro_torch.kernels.linrec.ref import linrec_ref
    g = torch.Generator(device="cuda").manual_seed(0)

    def ab(B, T, D, dtype):
        a = 0.7 + 0.299 * torch.rand(B, T, D, generator=g, device="cuda")
        b = 0.1 * torch.randn(B, T, D, generator=g, device="cuda")
        return a.to(dtype), b.to(dtype)

    def routes(a, b):
        return ("column", "tma") if tma_ok(a, b) else ("column",)

    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for B, T, D in LR_SWEEP:
            a, b = ab(B, T, D, dtype)
            for h0 in (None, torch.randn(B, D, generator=g, device="cuda")):
                want = linrec_ref(a, b, h0)
                for r in routes(a, b):
                    got = linrec_cuda(a, b, h0, route_name=r)
                    torch.cuda.synchronize()
                    check(torch.equal(got, want), f"linrec {name} B={B} T={T}"
                          f" D={D} h0={h0 is not None} route {r}: max |diff| "
                          f"{float((got - want).abs().max())}, not bit-equal")
                print(f"linrec {name} B={B} T={T} D={D} h0="
                      f"{'random' if h0 is not None else 'zeros'}: route "
                      f"{route(a, b)}; bit-equal to ref.py on "
                      f"{' and '.join(routes(a, b))}", flush=True)
    shapes = {f"{arch} prefill": (*shape, False)
              for arch, shape in LR_MAIN.items()}
    shapes[f"{SSM_ARCH} decode step"] = (SSM_BATCH, 1, 8192 * 16, True)
    recs = {}
    for label, (B, T, D, with_h0) in shapes.items():
        a, b = ab(B, T, D, torch.float32)
        h0 = torch.randn(B, D, generator=g, device="cuda") if with_h0 \
            else None
        want = linrec_ref(a, b, h0)
        err = 0.0
        for r in routes(a, b):
            got = linrec_cuda(a, b, h0, route_name=r)
            torch.cuda.synchronize()
            err = max(err, float((got - want).abs().max()))
            check(torch.equal(got, want), f"linrec {label} route {r}: not "
                  "bit-equal to ref.py")
        del got, want
        iters = 20 if T == 1 else 5
        # the column kernel beside the tma one in turns, three readings
        # each; a route's time is the median of its three
        ms = {}
        for r in ("column", "tma", "tma", "column", "column", "tma"):
            ms.setdefault(r, []).append(graph_ms(
                torch, lambda: linrec_cuda(a, b, h0, route_name=r), iters))
        ms = {r: statistics.median(v) for r, v in ms.items()}
        taken = route(a, b)
        plain_ms = graph_ms(torch, lambda: linrec_ref(a, b, h0),
                            iters if T == 1 else 1)
        call_ms = eager_ms(torch, lambda: linrec_cuda(a, b, h0), iters)
        n = B * T * D
        nbytes = 12 * n + (4 * B * D if with_h0 else 0)
        b_ms, b_by = bound(nbytes, 2 * n)
        recs[label] = {"shape": (B, T, D), "max_abs_err": err,
                       "route_taken": taken, "ms": ms[taken],
                       "column_ms": ms["column"], "tma_ms": ms["tma"],
                       "plain_ms": plain_ms, "library_ms": None,
                       "call_ms": call_ms, "bound_ms": b_ms,
                       "bound_by": b_by}
        print(f"linrec {label} B={B} T={T} D={D} fp32"
              f"{' from h0' if with_h0 else ''}: route {taken}; tma "
              f"{ms['tma']:.4f} ms ({b_ms / ms['tma']:.2%} of the bound), "
              f"column {ms['column']:.4f} ms "
              f"({b_ms / ms['column']:.2%}), plain {plain_ms:.4f} ms, "
              f"library none, bound {b_ms:.4f} ms ({b_by}; "
              f"{nbytes / 1e9:.3f} GB), python call {call_ms:.4f} ms, "
              "bit-equal on both routes", flush=True)
        del a, b, h0
        torch.cuda.empty_cache()
    return recs


def paper_suite(torch, card: str) -> dict:
    """The paper's figures and FedOpt at seed 0 through the suite's entry
    point (CSV to artifacts/paper_suite_seed0.csv), one fed_agg launch
    per merge; overhead's rows; fig18 at seeds 0-7 against the JAX
    harness's medians.  -> {"figures": fed_agg launches of the figures,
    "overhead": quant8 / fed_agg launches of the overhead bench}."""
    from repro_torch.examples.paper import fig18_async
    from repro_torch.examples.paper import run as paper_run
    from repro_torch.examples.paper.common import recorded_results
    from repro_torch.kernels.fed_agg import kernel
    from repro_torch.kernels.quant8 import kernel as q8
    from repro_torch.tree import leaves
    csv = io.StringIO()
    kernel.fed_agg_grouped_cuda.launches = 0
    with recorded_results() as results, contextlib.redirect_stdout(csv):
        suite = paper_run.main(["--only", PAPER_FIGURES, "--seed", "0"])
    torch.cuda.synchronize()
    launches = kernel.fed_agg_grouped_cuda.launches
    out_dir = ROOT / "artifacts"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "paper_suite_seed0.csv").write_text(csv.getvalue())
    for line in csv.getvalue().splitlines():
        if line.startswith(("summary,", "best,", "policy,")):
            print(line)
    for name, (_, wall) in suite.items():
        print(f"paper suite {name}: {wall:.3f} s wall ({card})")
    check(len(results) == PAPER_SIMS,
          f"the suite ran {len(results)} simulations, {PAPER_SIMS} expected")
    for res in results:
        check(len(res.records) > 1 and not res.crashed,
              "a suite simulation recorded nothing or crashed")
        check(all(0.0 <= r.acc <= 1.0 for r in res.records),
              "accuracy outside [0, 1]")
        for leaf in leaves(res.final_params):
            check(bool(torch.isfinite(leaf).all()),
                  "non-finite final params in the suite")
    merges = sum(res.records[-1].version for res in results)
    print(f"paper suite: {sum(w for _, w in suite.values()):.2f} s wall, "
          f"{len(results)} simulations, {merges} merges, {launches} fed_agg "
          f"launches", flush=True)
    check(launches == merges, f"the suite made {launches} fed_agg launches "
          f"in {merges} merges; one a merge expected")

    rows = io.StringIO()
    q8.quantize_grouped_cuda.launches = 0
    kernel.fed_agg_grouped_cuda.launches = 0
    with contextlib.redirect_stdout(rows):
        paper_run.main(["--only", "overhead", "--seed", "0"])
    overhead_launches = {"quant8_quantize": q8.quantize_grouped_cuda.launches,
                         "fed_agg": kernel.fed_agg_grouped_cuda.launches}
    lines = [l for l in rows.getvalue().splitlines()
             if l.count(",") == 2 and not l.startswith("bench.")]
    for line in lines:
        print(f"overhead ({card}): {line}")
    check(any(l.startswith("kernel.fed_agg") and l.endswith(",cuda")
              for l in lines), "overhead's fed_agg row did not run on cuda")
    check(min(overhead_launches.values()) > 0,
          f"overhead launched {overhead_launches}: quant8 and fed_agg "
          "expected")
    print(f"overhead launches: {overhead_launches}", flush=True)

    gains = {0: suite["fig18"][0]}
    for seed in sorted(JAX_FIG18)[1:]:
        with contextlib.redirect_stdout(io.StringIO()):
            gains[seed] = fig18_async.main(seed=seed)
    for seed, g in gains.items():
        print(f"fig18 seed {seed}: selection_gain {g['selection_gain']:.6f} "
              f"async_gain {g['async_gain']:.6f} (JAX "
              f"{JAX_FIG18[seed][0]:.6f} {JAX_FIG18[seed][1]:.6f})")
    for i, metric in enumerate(("selection_gain", "async_gain")):
        port_med = statistics.median(g[metric] for g in gains.values())
        jax_med = statistics.median(v[i] for v in JAX_FIG18.values())
        print(f"fig18 median {metric} over seeds 0-7: port {port_med:.6f}, "
              f"JAX {jax_med:.6f} (tolerance {FIG18_TOL[metric]})",
              flush=True)
        check(abs(port_med - jax_med) <= FIG18_TOL[metric],
              f"fig18 median {metric} {port_med} outside "
              f"{jax_med}+-{FIG18_TOL[metric]}")
    return {"figures": launches, "overhead": overhead_launches}


def resume_path(torch) -> int:
    """The resume fleet killed at sync round 2 / async merge 4 and resumed
    from its checkpoint on the card: killed + resumed must equal the
    uninterrupted run, records and params exactly, one fed_agg launch a
    merge.  -> fed_agg launches."""
    from repro_torch.examples import resume
    from repro_torch.kernels.fed_agg import kernel
    total = 0
    with tempfile.TemporaryDirectory() as d:
        for mode in ("sync", "async"):
            kernel.fed_agg_grouped_cuda.launches = 0
            ref, killed, resumed, merges = resume.crash_and_resume(
                mode, d, "cuda")
            torch.cuda.synchronize()
            launches = kernel.fed_agg_grouped_cuda.launches
            total += launches
            check(resume.holds(ref, killed, resumed),
                  f"{mode} resume differs from the uninterrupted run")
            check(launches == merges, f"{mode} resume: {launches} fed_agg "
                  f"launches in {merges} merges")
            print(f"resume {mode}: killed after {len(killed.records)} "
                  f"records at {'round' if mode == 'sync' else 'merge'} "
                  f"{resume.CRASH_AT[mode]}, resumed {len(resumed.records)}"
                  f": equal to the uninterrupted {len(ref.records)} records "
                  f"and its final params bit for bit; {launches} fed_agg "
                  f"launches in {merges} merges", flush=True)
    return total


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 1
    from repro_torch.core.hierarchy import FogTopology
    from repro_torch.examples import fl_exchange, quickstart
    from repro_torch.kernels.fed_agg import kernel
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.linrec import kernel as lrk
    from repro_torch.kernels.quant8 import kernel as q8
    from repro_torch.runtime import resolve_device
    from repro_torch.tree import leaves, tree_map

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    resolve_device("cuda")   # TF32 off, cuDNN deterministic (runtime.py)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    # 2. build from the checkout's sources, one nvcc per source at once
    def build(name, library):
        t0 = time.perf_counter()
        path = Path(library()._name).relative_to(ROOT)
        return f"built {name} in {time.perf_counter() - t0:.1f} s -> {path}"
    with ThreadPoolExecutor() as pool:
        for line in pool.map(build, ("fed_agg", "quant8", "flash_attention",
                                     "linrec"),
                             (kernel.library, q8.library, fa.library,
                              lrk.library)):
            print(line, flush=True)

    # 3. kernel vs plain version (launches here are not the main path's)
    rows = kernel_sweep(torch, np)
    fa_merge = fed_agg_tree_sweep(torch, np)

    # 4. main path: the quickstart on the card, counted from zero
    kernel.fed_agg_grouped_cuda.launches = 0
    t0 = time.perf_counter()
    result = quickstart.run("cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel.fed_agg_grouped_cuda.launches
    merges = result.records[-1].round
    print(f"quickstart (cuda): {wall:.2f} s wall, {merges} merges, "
          f"{launches} fed_agg launches ({launches / max(merges, 1):.2f} "
          f"per merge)", flush=True)
    check(launches == merges, f"the quickstart made {launches} fed_agg "
          f"launches in {merges} merges; one a merge expected")

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
        kernel.fed_agg_grouped_cuda.launches = 0
        sim = quickstart.make_simulation("cuda", policy="all", mode="sync",
                                         impl=impl)
        sync[impl] = (sim.run_sync(rounds=3), kernel.fed_agg_grouped_cuda.launches)
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
    # the fog fold alone, before training can amplify a rounding: the same
    # responses (seeded moves of the initial params) into a flat server
    # and a 2-cell server, one round each
    servers = {}
    for cells in (1, 2):
        sim = quickstart.make_simulation("cuda", policy="all", mode="sync")
        if cells > 1:
            sim.server.topology = FogTopology.round_robin(sim.workers, cells)
        servers[cells] = sim.server
    g = torch.Generator(device="cuda").manual_seed(0)
    responses = {w: tree_map(lambda p: p + 0.05 * torch.randn(
        p.shape, generator=g, device="cuda"), servers[1].params)
        for w in sorted(servers[1].stats)}
    merged = {}
    for cells, srv in servers.items():
        kernel.fed_agg_grouped_cuda.launches = 0
        srv.sync_aggregate(responses, 1.0)
        merged[cells] = (srv.params, kernel.fed_agg_grouped_cuda.launches)
    fold_gap = max(float((a - b).abs().max()) for a, b in
                   zip(leaves(merged[1][0]), leaves(merged[2][0])))
    check(fold_gap <= FOG_FOLD_TOL and merged[1][1] == 1
          and merged[2][1] == 3,
          f"fog fold of one round: params gap {fold_gap} from the flat "
          f"fold (tolerance {FOG_FOLD_TOL}), fed_agg launches flat "
          f"{merged[1][1]}, 2 cells {merged[2][1]}")
    print(f"one round of the same {len(responses)} responses, flat vs 2 "
          f"fog cells: merged params max |diff| {fold_gap:.3g} (tolerance "
          f"{FOG_FOLD_TOL}), fed_agg launches {merged[1][1]} and "
          f"{merged[2][1]}", flush=True)
    # the same 3 sync rounds folded edge -> fog -> cloud: 2 cells + the
    # cloud; 4 local epochs a round amplify the fold's rounding, so
    # accuracy is held here, the params above
    kernel.fed_agg_grouped_cuda.launches = 0
    sim = quickstart.make_simulation("cuda", policy="all", mode="sync")
    sim.server.topology = FogTopology.round_robin(sim.workers, 2)
    rf = sim.run_sync(rounds=3)
    nf = kernel.fed_agg_grouped_cuda.launches
    fog_acc = max(abs(a.acc - b.acc) for a, b in zip(rk.records, rf.records))
    fog_gap = max(float((a - b).abs().max()) for a, b in
                  zip(leaves(rk.final_params), leaves(rf.final_params)))
    check([(r.time, r.round) for r in rk.records]
          == [(r.time, r.round) for r in rf.records],
          "fog-tier sync time/round columns differ from the flat run")
    check(fog_acc <= 0.01 and nf == 3 * rounds,
          f"fog-tier sync: acc gap {fog_acc}, {nf} fed_agg launches")
    print(f"sync all-policy through 2 fog cells: acc gap {fog_acc:.4g} and "
          f"final params max |diff| {fog_gap:.3g} from the flat run, "
          f"{nf / rounds:.0f} fed_agg launches per round", flush=True)

    # 5. the paper's experiment suite on the card, counted from zero
    paper_launches = paper_suite(torch, card)

    # 6. crash-safe resume on the card, counted from zero
    resume_launches = resume_path(torch)

    # 7. quant8 kernels vs plain version (launches here are not the path's)
    q8_rows = quant8_sweep(torch)
    quant8_mixed_lists(torch)
    q8_main = quant8_exchange_shapes(torch)

    # 8. the exchange path, counted from zero: the entry point at P = 2,
    #    4, 8 x 4 modes, flat and two-tier, and the paper's model on islands
    q8.quantize_grouped_cuda.launches = q8.dequantize_grouped_cuda.launches = 0
    t0 = time.perf_counter()
    ex_kernel = exchange_path(torch)
    params_k, accs_k = fl_exchange.island_rounds("cuda")
    torch.cuda.synchronize()
    q8_launches = {"quantize": q8.quantize_grouped_cuda.launches,
                   "dequantize": q8.dequantize_grouped_cuda.launches}
    print(f"exchange path: {time.perf_counter() - t0:.2f} s wall, quant8 "
          f"launches {q8_launches}", flush=True)
    check(min(q8_launches.values()) > 0,
          "the exchange path launched no quant8 kernel")
    def q8_count():
        return (q8.quantize_grouped_cuda.launches,
                q8.dequantize_grouped_cuda.launches)
    # one grouped quantise and dequantise per hop: 2 launches flat, 4
    # through the fog tier (10 and 20 when each leaf had its own)
    for fog_cells, hops in ((1, 1), (2, 2)):
        stacked, base = fl_exchange.make_tree(EXCHANGE_P, device="cuda")
        fn = fl_exchange.exchange_fn(EXCHANGE_P, "q8", fog_cells=fog_cells,
                                     device=torch.device("cuda"))
        before = q8_count()
        fn(stacked, base)
        n = tuple(a - b for a, b in zip(q8_count(), before))
        check(n == (hops, hops), f"q8 exchange ({fog_cells} cells): quant8 "
              f"launches {n}, expected {2 * hops} ({hops} each)")
        print(f"one q8 exchange, {'flat' if fog_cells == 1 else 'two-tier'}"
              f": {sum(n)} quant8 launches ({n[0]} quantise, {n[1]} "
              "dequantise)", flush=True)
    before = q8_count()
    for fog_cells, outs in ex_kernel.items():
        _, plain = fl_exchange.run("cuda", fog_cells=fog_cells, impl="ref",
                                   rounds=1)
        gap = max(fl_exchange.max_abs_diff(outs[k], plain[k]) for k in outs)
        check(gap == 0.0, f"kernel vs plain exchange ({fog_cells} cells): "
              f"max |diff| {gap}")
        print(f"fl_exchange {fog_cells} cell(s): kernel vs plain outputs "
              f"max |diff| {gap} over {len(outs)} cells", flush=True)
    params_r, accs_r = fl_exchange.island_rounds("cuda", impl="ref")
    check(q8_count() == before,
          "a plain (impl='ref') run launched a quant8 kernel")
    island_gap = max(float((a - b).abs().max()) for a, b in
                     zip(leaves(params_k), leaves(params_r)))
    check(island_gap == 0.0 and accs_k == accs_r,
          f"flight-cnn-mnist islands: kernel vs plain params {island_gap}")
    for leaf in leaves(params_k):
        check(bool(torch.isfinite(leaf).all()), "non-finite island params")
    print(f"flight-cnn-mnist, 4 islands, 2 fog cells, q8, 3 rounds: "
          f"accuracy {accs_k} through the kernels, {accs_r} plain; final "
          f"params max |diff| {island_gap}", flush=True)

    # 9. flash_attention vs plain version (launches here are not the path's)
    fa_recs = flash_sweep(torch)
    fa_main = fa_recs[LM_ARCH]

    # 10. the LM serving path at full width, counted from zero
    res, lm_launches, lm_peak = lm_serve(torch, LM_ARCH, LM_BATCH)
    model, params = res["model"], res["params"]
    del res
    lm_kernel_vs_plain(torch, model, params)

    # 11. continuous batching at full width, counted from zero
    loop_launches = lm_serve_loop(torch, model, params, LOOP_LENGTHS)
    del model, params
    torch.cuda.empty_cache()

    # 12. linrec vs plain version (launches here are not the path's)
    lr_main = linrec_sweep(torch)

    # 13. falcon-mamba-7b at full width, counted from zero
    res, ssm_launches, ssm_peak = lm_serve(torch, SSM_ARCH, SSM_BATCH)
    model, params = res["model"], res["params"]
    del res
    lm_kernel_vs_plain(torch, model, params)

    # 14. falcon-mamba-7b in the ServeLoop, counted from zero
    ssm_loop_launches = lm_serve_loop(torch, model, params, SSM_LOOP_LENGTHS)
    del model, params
    torch.cuda.empty_cache()

    # 15. recurrentgemma-9b at full width, counted from zero
    res, hybrid_launches, hybrid_peak = lm_serve(torch, HYBRID_ARCH,
                                                 HYBRID_BATCH)
    model, params = res["model"], res["params"]
    del res
    lm_kernel_vs_plain(torch, model, params)
    del model, params
    torch.cuda.empty_cache()

    # 16. results
    # fed_agg on its main path: one grouped launch over the async merge's
    # tree; library_ms is one einsum over the same elements as a (2, N)
    # stack (the sweep's (2, 20,490) row), which no tree call has
    main_row = next(r for r in rows if (r["K"], r["N"], r["dtype"])
                    == MAIN_SHAPE)
    table = [{
        "name": "fed_agg", "route": "cuda",
        "source": "src/repro_torch/kernels/fed_agg/csrc/fed_agg.cu",
        "replaces": "src/repro/kernels/fed_agg/kernel.py:40",
        # every merge path's launches: each counted from zero around it
        "launches": launches + paper_launches["figures"] + resume_launches,
        "launches_by_path": {"quickstart": launches,
                             "paper_suite": paper_launches["figures"],
                             "resume": resume_launches},
        "max_abs_err": fa_merge["max_abs_err"],
        "ms": fa_merge["ms"], "plain_ms": fa_merge["plain_ms"],
        "bound_ms": fa_merge["bound_ms"], "bound_by": fa_merge["bound_by"],
        "library_ms": main_row["library_ms"],
        "floor_ms": fa_merge["floor_ms"],
        "async_merge_call_ms": fa_merge["async_merge_call_ms"]}]
    for name, line in (("quantize", 46), ("dequantize", 68)):
        # one grouped launch over the exchange: the ms keys cold (L2
        # flushed first), the *_warm_ms keys with the inputs in L2
        t = q8_main[name]
        table.append({
            "name": f"quant8_{name}", "route": "cuda",
            "source": "src/repro_torch/kernels/quant8/csrc/quant8.cu",
            "replaces": f"src/repro/kernels/quant8/kernel.py:{line}",
            "launches": q8_launches[name], "max_abs_err": t["max_abs_err"],
            **({"overhead_launches":
                paper_launches["overhead"]["quant8_quantize"]}
               if name == "quantize" else {}),
            "ms": t["grouped_cold_ms"], "plain_ms": t["plain_cold_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_cold_ms"],
            "warm_ms": t["grouped_ms"], "plain_warm_ms": t["plain_ms"],
            "library_warm_ms": t["library_ms"]})
    table.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:105",
        "launches": sum(r["flash_attention"] for r in (
            lm_launches, loop_launches, hybrid_launches)),
        "max_abs_err": fa_main["max_abs_err"], "ms": fa_main["ms"],
        "plain_ms": fa_main["plain_ms"], "bound_ms": fa_main["bound_ms"],
        "bound_by": fa_main["bound_by"],
        "library_ms": fa_main["library_ms"]})
    # linrec on its main path: the tma route at falcon's prefill scan; the
    # column kernel (the other route) read in the same call
    lr = lr_main[f"{SSM_ARCH} prefill"]
    table.append({
        "name": "linrec", "route": "cuda",
        "source": "src/repro_torch/kernels/linrec/csrc/linrec.cu",
        "replaces": "src/repro/kernels/linrec/kernel.py:66",
        "launches": sum(r["linrec"] for r in (
            ssm_launches, ssm_loop_launches, hybrid_launches)),
        "max_abs_err": max(r["max_abs_err"] for r in lr_main.values()),
        "ms": lr["ms"], "plain_ms": lr["plain_ms"],
        "bound_ms": lr["bound_ms"], "bound_by": lr["bound_by"],
        "library_ms": lr["library_ms"], "kernel_route": lr["route_taken"],
        "column_ms": lr["column_ms"],
        "narrow_ms": lr_main[f"{HYBRID_ARCH} prefill"]["ms"],
        "narrow_bound_ms": lr_main[f"{HYBRID_ARCH} prefill"]["bound_ms"]})
    print(f"quant8 sweep: {len(q8_rows)} shapes x 2 kernels, all bit-equal",
          flush=True)
    print(f"launches: {LM_ARCH} serve {lm_launches}, ServeLoop "
          f"{loop_launches}; {SSM_ARCH} serve {ssm_launches}, ServeLoop "
          f"{ssm_loop_launches}; {HYBRID_ARCH} serve {hybrid_launches}. "
          f"Serve peak memory: {LM_ARCH} {lm_peak:.2f} GB, {SSM_ARCH} "
          f"{ssm_peak:.2f} GB, {HYBRID_ARCH} {hybrid_peak:.2f} GB",
          flush=True)
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

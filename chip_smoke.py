#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100).

  python3 chip_smoke.py

Phases, in order; any failure exits non-zero and nothing is caught:
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from src/repro_torch/kernels/*/csrc, one nvcc
     per library (the training library once per head dim it holds, 64
     and 128), all started together;
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
  7. the scenario engine (core/scenarios.py) at 10^3 and 10^5 workers:
     examples/fl_scale's four cells (5 sync rounds, 64 async merges under
     churn, stragglers and drift), whose record streams must equal the
     JAX engine's (JAX_FL_SCALE: digest, length, last record) and best
     accuracies equal to its (SCENARIO_ACC_TOL = 0), with one fed_agg
     launch an async merge and none a sync round; 64 async merges of
     flight-cnn-mnist at 10^5 workers through the kernel and through the
     plain version (records equal, params bit-equal); examples/fl_faults'
     six cells with the benchmark's invariants, the clean and robust
     cells' best accuracies equal to the JAX engine's (SCENARIO_ACC_TOL)
     and the quarantine counts equal to its; the scenario fleet of the
     JAX package's resume test killed at sync round 2 and async merge 5
     and resumed (equal to the uninterrupted run, params bit-equal); then
     examples/profile_scenarios' breakdown of the 10^5-worker loop;
  8. hold the grouped quant8 kernels (quantise, dequantise; one launch
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
  9. the exchange path: examples/fl_exchange at P = 2, 4, 8 in the modes
     f32, q8, topk and q8_topk, flat and two-tier, through the kernels and
     through the plain version (equal outputs; wire MB equal to the JAX
     benchmark's BENCH_exchange.json); one q8 exchange must be 2 quant8
     launches flat and 4 two-tier (one grouped quantise and dequantise a
     hop), a plain one 0; then 4 islands of flight-cnn-mnist, 3 rounds of
     one local epoch and a q8 exchange through 2 fog cells, through the
     kernels and the plain version, which must give equal final params;
  10. hold flash_attention against its plain version over
     tests/test_kernels.py's shapes, odd T (1, 77, 1,000, 4,097), D = 8,
     12, 16, 200, 256, windows off the tile grid, non-causal, fp32 and
     bf16 (3e-4 / 3e-2), and strided views on the mma.sync and FMA routes,
     printing each shape's route (kernel.route: wgmma for bf16 that TMA
     can describe, mma / fma for the rest), mixtral-8x22b's GQA group of 6
     under its window of 4,096 at T = 5,000, qwen3-moe's group of 16
     at D = 64, phi-3-vision's D = 96 under MHA 32/32 (T = 77 and 2,048,
     and a strided view on mma.sync) and seamless-m4t's non-causal D = 64
     among them; then time it at granite-20b's and recurrentgemma-9b's
     full-width prefill shapes, at those two MoE shapes and at
     phi-3-vision's and seamless-m4t's (encoder, decoder) beside the
     bound, the plain version and one
     scaled_dot_product_attention call (a yardstick the port never calls;
     a window the prompt passes as a boolean mask over K/V repeated to
     every head);
  10b. hold the training kernels (flash_attention_train: the forward with
     its row log-sum-exp, the backward) against torch.autograd of
     attention_full in fp32 and ref.py's blockwise backward over
     FA_TRAIN_SHAPES (the benchmark cell's 8 x 1,024 x 20 heads of 128,
     phase 25's microbatch, GQA under a window, non-causal, D = 96 and an
     odd T at D = 64), their forward's o equal to the prefill kernel's and
     two backwards equal, bit for bit; time both at the cell's shape beside
     their bounds, attention_full's forward and backward and
     scaled_dot_product_attention's (a yardstick);
  (a) the hardware model (dist/hardware.py) against the card: a bf16
     torch.matmul at 8,192^3 and a 4 GB device-to-device copy in
     CUDA-graph time, neither above its constant (989 TFLOP/s, 3.35
     TB/s), and total_memory beside DEVICE_HBM_BYTES;
  11. the LM serving path at granite-20b's full width (20.32 B params,
     bf16, drawn on the card): `python -m repro_torch.launch.serve --full
     --batch 8 --prompt-len 2048 --gen 32` through its main, which must
     launch flash_attention once per layer (52), all on the wgmma route;
     (b) its layout decision (serve.pick_layout on the host mesh) must be
     stationary+head/bf16, its predicted param and cache bytes the drawn
     params' and the allocated cache's exactly, its predicted peak
     printed beside the measured one;
     then a batch of 2 x 2,048
     prefilled through the kernel, each layer's attention held against the
     plain version on the same q/k/v (3e-2), and again through the plain
     version: last-position logits within 2e-2 scale-relative;
  12. the continuous-batching ServeLoop at full width (4 slots, 4,096
     positions) draining 8 requests of 1 to 2,047 prompt tokens, 16 new
     tokens each: one flash launch per layer per admitted prefill, each
     first token equal to its solo prefill's; token agreement with solo
     generation is reported; (c) a ServeLoop the policy sizes,
     ServeLoop(max_batch=48, max_len=32768, mesh=make_host_mesh()), on
     phase 11's params: the decision must be stationary+head/int8
     (head/bf16 over the 72 GB cap), the allocated cache its predicted
     bytes exactly; prompts of 1, 77, 300 and 2,047 tokens, 16 new
     tokens each: per admitted prefill 52 flash launches (wgmma) and 52
     grouped quantises, per decode step 52 grouped quantises
     (cache.write_kv) and 52 dequantises (cache.read_kv), each quant8
     call bit-equal to the plain version, each first token its solo
     prefill's; the same prompts again, unchecked, for the peak, which
     must stay under 80 GB; then 32 slots, which must decide head/bf16,
     one request admitted and its peak read; (d) the cost walk
     (dist/cost.py) of phase 11's prefill on the card and on meta
     tensors: flops by dtype, bytes and ops equal, the kernels reporting
     by formula on both, the walk's roofline bound not above the
     measured step time (bound, time, share, dominant term printed);
  13. paged serving at full width: `python -m repro_torch.launch.serve
     --full --paged --batch 8 --prompt-len 512 --gen 32` through its main
     (16 requests through PagedServeLoop's 8 slots, a pool of 273 blocks
     of 16): every request drains with 32 tokens, the allocator's
     invariants hold and every block is free or cached once drained, and
     no flash_attention launch (the paged prefill attention is the
     reference's plain route); chunk steps, decode steps, ms per decode
     tick and peak memory printed;
  14. paged against contiguous at full width: examples/serve_load's
     shared-prefix parity trace on the virtual clock (tick 0.01 s)
     through PagedServeLoop (its POOL: 4 slots, 48 x 8 blocks, chunks of
     32; the allocator's invariants after every tick) and the contiguous
     ServeLoop (384 positions), the logits behind every token recorded in
     both: prefix blocks shared; while a paged stream agrees with its
     contiguous one (whose first token is the request's solo prefill) the
     two runs' logits lie within serve_load.FULL_LOGITS_TOL
     (scale-relative; examples/parity_gap.py's readings set it), and a
     stream parts only where the contiguous run's two best logits lie
     within twice that step's difference (counted and printed, with the
     share of contiguous steps so close);
  15. contiguous chunked prefill into an int8 cache at full width: 2 x
     2,048 through make_chunk_prefill_step in 4 chunks of 512 into a
     head/int8 cache of 2,080 positions, then 8 decode steps: one
     grouped quant8 quantise and dequantise per layer per chunk and per
     step (624 each, added to the quant8 rows' launches), each call's K
     and V bit-equal to the plain version on the same inputs; the last
     chunk's logits within LM_LOGITS_TOL of a one-shot prefill's into
     the same spec, the decode streams under phase 14's rule and
     tolerance;
  16. hold linrec against its plain version, bit for bit, over
     tests/test_kernels.py's shapes, odd T (1, 77, 1,000) and odd D (12,
     130), with and without a starting state, fp32 and bf16, on each route
     that takes the shape (column always, tma where TMA can describe it),
     printing the route kernel.route picks; and time both routes at both
     recurrent models' prefill scans and a falcon decode step, in turns
     (the median of three readings a route), beside the bound and the plain version (no single PyTorch call
     computes it);
  17. falcon-mamba-7b at full width (7.27 B params, bf16, drawn on the
     card): `python -m repro_torch.launch.serve --arch falcon-mamba-7b
     --full --batch 4 --prompt-len 2048 --gen 32` through its main, which
     must launch linrec once per layer in the prefill (64, all on the tma
     route) and in each decode step (64, on the column route); then a batch of 2 x 2,048 prefilled through the
     kernel, each layer's scan held against the plain version on the same
     a, b (2e-4), and again through the plain version: last-position
     logits within 2e-2 scale-relative;
  18. falcon-mamba-7b in a full-width ServeLoop (4 slots) draining 8
     requests of 3 to 2,047 prompt tokens, 16 new tokens each: one linrec
     launch per layer per admitted prefill and per decode step, each first
     token equal to its solo prefill's; agreement with solo generation is
     reported;
  19. recurrentgemma-9b at full width (10.44 B params): `serve.py --arch
     recurrentgemma-9b --full --batch 2 --prompt-len 2048 --gen 32`, 26
     linrec and 12 flash launches (wgmma route) in the prefill and 26 linrec launches a
     decode step; then its 2 x 2,048 prefill's attention and scans held
     layer by layer against the plain versions, and its last-position
     logits against the plain run's: within 3.5e-2 (see LM_LOGITS_TOL);
  20. mixtral-8x22b at full width cut to 8 of its 56 layers (20.44 B
     params, 40.87 GB in bf16; the whole model is 140.6 B), served
     through serve.py's serve_config at 4 x 2,048 prompts and 32 new
     tokens: 8 flash launches in the prefill, all wgmma, none a decode
     step; its 2 x 2,048 prefill held layer by layer against the plain
     attention (3e-2) and in its last-position logits (LM_LOGITS_TOL),
     and each layer's routing on the card (choices, positions, drops)
     equal bit for bit to moe_route on the CPU from the same copied
     probabilities, the share of dropped choices printed; then a
     ServeLoop (4 slots x 4,096) draining prompts of 1, 77, 300 and
     2,047 tokens, 16 new tokens each, each first token equal to its
     solo prefill's; and one MoE layer's device time by part (router and
     routing, dispatch, expert products beside their bound, combine) at
     the serve's prefill and decode shapes;
  21. qwen3-moe-235b-a22b the same (8 of 94 layers, 20.86 B params,
     41.72 GB; 128 experts, top-8);
  22. phi-3-vision-4.2b at full width (3.82 B params, nothing cut):
     `serve.py --arch phi-3-vision-4.2b --full --batch 8 --prompt-len
     2048 --gen 32` through its main (576 patch embeddings and 1,472 text
     positions a prompt), 32 flash launches in the prefill, all wgmma
     (D = 96), none a decode step; its 2 x 2,048 prefill's attention held
     layer by layer against the plain version (3e-2) and its
     last-position logits within LM_LOGITS_TOL; then a ServeLoop (4 slots
     x 4,096) draining text prompts of 1, 77, 300 and 2,047 tokens, 16 new
     tokens each, each first token equal to its solo prefill's;
  23. seamless-m4t-large-v2 at full width (1.63 B params, nothing cut):
     the same fixed-batch serve (8 x 2,048 frames and tokens, 32 new
     tokens), 72 flash launches a prefill (24 encoder, non-causal; 24
     decoder self attention; 24 cross attention, non-causal, frames as
     long as the prompt), all wgmma, none a decode step; the check
     prefill held layer by layer (encoder, self and cross attention) and
     in its logits; its ServeLoop must be refused, as the reference's
     cannot serve it;
  24. the training path, on every smoke arch: two adamw steps
     (examples/train_gap.py, lr 1e-2, clip 1.0) on the card and on the
     CPU from the same params and batch, for the ten assigned archs and
     both flight CNNs, and with grad_accum = 2 and with remat on for
     qwen1.5-4b and falcon-mamba-7b: metrics, moments and params held to
     train_gap.TOL (the tolerances tests/test_torch_train.py holds the
     CPU to against JAX), no flash_attention (prefill or training: the
     smoke heads are below the training kernels'), linrec or quant8
     launch;
  25. qwen1.5-4b trained at full width, whole (3.95 B params, 40 layers,
     grad_accum 4, remat on): `python -m repro_torch.launch.train --arch
     qwen1.5-4b --full --islands 1 --steps 3 --batch 4 --seq 1024`
     through its main, 3 finite steps, every gradient-carrying attention
     call on the training kernels (960 forwards under remat, 480
     backwards) and no other kernel launch, each step's time,
     tokens/s and share of the dense bf16 peak (6 N tokens) and the peak
     memory printed; adamw's in-place update on the card against the
     CPU's for the middle layer's slice of each stacked leaf (moments 1e-6
     relative, params one bf16 ulp); the first step's loss against the
     same batch's loss with no gradient (the serving route, flash) within
     TRAIN_ROUTE_TOL, beside the train route's gap under a planted fault
     (a query seeing one key ahead), a one-ulp nudge and a mask fault;
  26. its federated loop at full width cut to 4 layers (1.10 B params an
     island), 2 islands x 4 steps, 2 local steps, under --compress q8,
     q8 through 2 fog cells with --overlap, and q8-topk with half the
     islands Byzantine folded by trimmed mean: quant8 launches by hop (2 +
     2, 4 + 4 and 4 + 4), each call bit-equal to the plain version, the
     reference's tags, the islands agreeing after the last exchange, every
     attention call on the training kernels and none plain; then
     the q8 run killed after step 2 and resumed from its checkpoint, its
     params and adamw state equal to the uninterrupted run's bit for bit
     under torch.use_deterministic_algorithms; before it, (d) the cost
     walk of phase 25's train step (4 x 1,024, grad_accum 4, remat) on
     the card (its attention on the training kernels, by formula) and on
     meta (the plain route), printed apart (both walks written to
     artifacts/cost_walk_card.json for examples/gen_experiments.py);
  27. print the kernel table as JSON (flash_attention's and linrec's
     launches by path, the training paths' among them, 0; the training
     kernels' launches by path; quant8's train exchange launches; (e)
     phase (c)'s launches by path), then the result line.

Each model is freed before the next one is drawn (40.6 GB of weights
for phases 11-12 and again for 13-15, then 14.6, 20.9, 40.9, 41.7, 7.6
and 3.3 GB; phase 25's 7.9 GB of bf16 weights, 31.6 GB of adamw moments
and 15.8 GB of fp32 gradient accumulator).
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

# the card's constants and each kernel's work formula, one copy for the
# bound column and the cost walk (dist/hardware.py; numpy only)
from repro_torch.dist.hardware import (  # noqa: E402
    BF16_FLOPS_PER_S, DEVICE_HBM_BYTES, HBM_BYTES_PER_S, fed_agg_work,
    flash_attention_train_bwd_work, flash_attention_train_fwd_work,
    flash_attention_work, linrec_work, quant8_dequantize_work,
    quant8_quantize_work, work_bound)

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
# the scenario engine's workloads (examples/fl_scale.py, fl_faults.py) on
# the JAX engine on the CPU, as printed by `PYTHONPATH=src
# JAX_PLATFORMS=cpu python tests/test_torch_scenarios.py`.  fl_scale, per
# cell: best accuracy, the digest of the time / round / n_selected /
# version columns (fl_scale.stream_digest), the number of records and the
# last record.  fl_faults, per cell: best accuracy, workers quarantined.
JAX_FL_SCALE = {
    "sync_n1000": (0.11328125, "f54a3647035cc886", 6,
                   (10.791956815064248, 5, 46, 5)),
    "async_n1000": (0.13671875, "3ff0d048f6f386f4", 65,
                    (0.4771685023322979, 64, 1, 64)),
    "sync_n100000": (0.126953125, "e52974767a17f226", 6,
                     (14.719007757081545, 5, 4546, 5)),
    "async_n100000": (0.123046875, "ba993d6353a62e19", 65,
                      (0.1550032899296343, 64, 1, 64))}
JAX_FL_FAULTS = {"clean_fedavg": (0.947265625, 0),
                 "attacked_fedavg": (0.2265625, 0),
                 "attacked_trimmed": (0.94140625, 0),
                 "attacked_krum": (0.9453125, 0),
                 "attacked_median": (0.935546875, 0),
                 "attacked_nonfinite": (0.953125, 47)}
# best accuracy of the fl_scale cells and of fl_faults' clean and robust
# cells: twice the largest shift of the JAX value when every initial param
# moves one ulp up or down; no value moved (`python
# tests/test_torch_scenarios.py` prints "tolerance 0.0"), so they are held
# exactly (PERF.md section 6).  attacked_fedavg's value is chaotic (0.2266,
# one ulp down 0.2207): only its invariant is held.
SCENARIO_ACC_TOL = 0.0
SCENARIO_HELD = ("clean_fedavg", "attacked_trimmed", "attacked_krum",
                 "attacked_median")
# quant8 sweep: row width C (5: odd; 256: the exchange's matrices; 1027:
# its bias; 4096; 151,936: an LM head's vocabulary row) x total elements
Q8_WIDTHS = (5, 256, 1027, 4096, 151_936)
Q8_ODD_VOCAB = 50_257              # a vocabulary row of no 16-byte multiple
Q8_TOTALS = (1 << 10, 1 << 14, 1 << 18, 1 << 22, 1 << 26)
EXCHANGE_P = 8                     # the exchange's leaf shapes at P islands
Q8_LONG_LIST = 70                  # leaves: more than two tables' capacity
L2_FLUSH_BYTES = 256 << 20         # read between cold calls: 5x the L2
# granite-20b's int8 decode cache as read_kv dequantises it: rows = batch
# x (prompt + models/cache.py's PREFILL_DECODE_MARGIN of 128) x 1 KV head
KV_READ_ROWS, KV_HEAD_DIM = 8 * (2048 + 128) * 1, 128
# flash_attention sweep (B, T, H, Hkv, D, window, causal): test_kernels.py's
# five shapes, odd T, the smoke configs' head dims, non-causal, then a tail
# tile of one key, D = 256 under a window off the tile grid, granite's group
# of 48, then the MoE archs' prefill heads (FA_MOE, also timed beside the
# bound): mixtral-8x22b's GQA group of 6 under its window of 4,096 with T
# past it, qwen3-moe's group of 16 at D = 64; bf16 takes the wgmma kernel
# wherever D % 8 == 0 (D = 12: mma.sync)
FA_MOE = {"mixtral-8x22b": (1, 5000, 48, 8, 128, 4096),
          "qwen3-moe-235b-a22b": (2, 2048, 64, 4, 64, 0)}
FA_SWEEP = [(2, 256, 4, 4, 64, 0, True), (2, 256, 4, 2, 64, 0, True),
            (2, 512, 8, 1, 128, 0, True), (2, 512, 4, 2, 64, 128, True),
            (2, 1024, 2, 2, 64, 300, True), (2, 1, 48, 1, 128, 0, True),
            (2, 77, 48, 1, 128, 0, True), (1, 1000, 48, 1, 128, 0, True),
            (2, 77, 8, 2, 8, 0, True), (2, 100, 4, 4, 12, 0, True),
            (2, 130, 4, 1, 16, 0, True), (2, 77, 4, 2, 64, 0, False),
            (1, 300, 8, 8, 128, 0, False), (1, 130, 3, 3, 200, 50, False),
            (1, 300, 4, 1, 256, 0, True), (1, 4097, 4, 1, 128, 0, True),
            (2, 700, 4, 1, 256, 300, True), (1, 520, 48, 1, 128, 0, True),
            *((*shape, True) for shape in FA_MOE.values()),
            # phi-3-vision's D = 96 under MHA 32/32, padded to 128 by the
            # TMA box (an odd T, and its prefill length); seamless-m4t's
            # non-causal D = 64 (its encoder and cross attention)
            (2, 77, 32, 32, 96, 0, True), (1, 2048, 32, 32, 96, 0, True),
            (1, 300, 16, 16, 64, 0, False), (2, 2048, 16, 16, 64, 0, False)]
# bf16 q/k/v as views of one fused (B, T, 6, D + pad) projection, (D, pad,
# route): a row padded by 8 keeps TMA's strides; by 1, mma.sync (D <= 128)
# or the FMA kernel (D > 128) takes it
FA_STRIDED = [(128, 8, "wgmma"), (64, 1, "mma"), (200, 1, "fma"),
              (96, 1, "mma")]
FA_TOL = {"float32": 3e-4, "bfloat16": 3e-2}    # tests/test_kernels.py
# the training kernels (phase 10b), as tests/test_torch_cuda.py's
# TRAIN_SHAPES: (B, T, H, Hkv, D, window, causal), the first the
# benchmark cell's (qwen1.5-4b, 8 x 1,024), which is timed; o, dq, dk and
# dv within FA_TRAIN_TOL of the largest entry of attention_full's autograd
# in fp32 and of ref.py's blockwise backward (bf16 outputs; the card read
# 1.9e-3 to 3.8e-3: PERF.md section 6), o + o_lo within 1e-4 of the fp32
# output
FA_TRAIN_SHAPES = [(8, 1024, 20, 20, 128, 0, True),
                   (1, 1024, 20, 20, 128, 0, True),
                   (2, 333, 8, 2, 64, 100, True), (1, 300, 4, 4, 128, 0, False),
                   (1, 520, 8, 2, 96, 0, True), (2, 77, 4, 2, 64, 0, True)]
FA_TRAIN_TOL = 1e-2
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
# The MoE archs cut in depth (logits_gap.DEPTH_CUT): a bf16 ulp in
# attention can move a token across a near tie of its router, or across an
# expert's capacity, which moves its hidden state by O(1), and partings
# compound layer by layer (qwen3-moe's plain prefill routes 55 % of the
# tokens of its 8th layer otherwise).  Each tolerance lies between the
# arch's rounding readings (the kernels and a one-ulp nudge) and its
# smallest planted fault, from examples/logits_gap.py on an H100: mixtral
# 0.0120 and 0.0137 against 0.0873, qwen3-moe 0.0877 and 0.0395 against
# 0.2119 (PERF.md section 6).  The attention kernel is held per layer at
# 3e-2 and the routing bit for bit besides.
MOE_LOGITS_TOL = {"mixtral-8x22b": 3.5e-2, "qwen3-moe-235b-a22b": 0.14}
# phi-3-vision-4.2b and seamless-m4t-large-v2 at full width, nothing cut,
# each near the geometric mean of its largest rounding reading and its
# smallest planted fault (examples/logits_gap.py on an H100, PERF.md
# section 6): phi-3-vision kernels 0.0220, nudge 0.0238 against drop_head
# 0.1268; seamless-m4t kernels 0.0121, nudge 0.0106 against drop_head
# (its decoder's self attention) 0.0163, the encoder's 0.0237, the cross
# attention's 0.0940.  seamless-m4t's margin is narrow (1.16x its kernel
# reading, which repeats to the digit on these fixed inputs); its
# attention is held per layer and per kind at 3e-2 besides.
FAMILY_LOGITS_TOL = {"phi-3-vision-4.2b": 5.5e-2,
                     "seamless-m4t-large-v2": 1.4e-2}
LM_LOGITS_TOL = {"granite-20b": 2e-2, "falcon-mamba-7b": 2e-2,
                 "recurrentgemma-9b": 3.5e-2, **MOE_LOGITS_TOL,
                 **FAMILY_LOGITS_TOL}
LOOP_LENGTHS = (1, 77, 300, 1000, 2047, 513, 64, 1500)
LOOP_SLOTS, LOOP_MAX_LEN, LOOP_NEW = 4, 4096, 16
# paged serving through serve.py --paged: batch slots, prompt, new tokens
# (2 x batch requests; the pool sized batch x (prompt + gen) + one block)
PAGED_BATCH, PAGED_PROMPT, PAGED_GEN = 8, 512, 32
# contiguous chunked prefill into an int8 cache: batch, prompt, chunk,
# cache positions, decode steps after it
CHUNK_BATCH, CHUNK_PROMPT, CHUNK_LEN, CHUNK_CACHE, CHUNK_STEPS = \
    2, 2048, 512, 2080, 8
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
# the MoE archs at full width, cut to examples/logits_gap.py's DEPTH_CUT
# of 8 layers (neither fits one card whole: 140.6 and 231.7 B params),
# served at MOE_BATCH x LM_PROMPT
MOE_ARCHS = ("mixtral-8x22b", "qwen3-moe-235b-a22b")
MOE_BATCH = 4
MOE_LOOP_LENGTHS = (1, 77, 300, 2047)
# the VLM stub and the enc-dec at full width, nothing cut, served at
# FAMILY_BATCH x LM_PROMPT (phi-3-vision: 576 patch embeddings and 1,472
# text positions a prompt; seamless-m4t: LM_PROMPT frames and tokens)
VLM_ARCH, AUDIO_ARCH = "phi-3-vision-4.2b", "seamless-m4t-large-v2"
FAMILY_BATCH = 8
FAMILY_LOOP_LENGTHS = (1, 77, 300, 2047)    # the VLM's ServeLoop prompts
# their prefill attention (B, T, H, Hkv, D, window, causal), timed beside
# the bound: phi-3-vision's D = 96; seamless-m4t's encoder (its cross
# attention, at T == S, has the same shape) and decoder self attention
FA_FAMILY = {VLM_ARCH: (FAMILY_BATCH, LM_PROMPT, 32, 32, 96, 0, True),
             f"{AUDIO_ARCH} encoder": (FAMILY_BATCH, LM_PROMPT, 16, 16, 64,
                                       0, False),
             f"{AUDIO_ARCH} decoder": (FAMILY_BATCH, LM_PROMPT, 16, 16, 64,
                                       0, True)}
# the training path (phases 24-26).  Phase 24: every smoke arch's train
# step (examples/train_gap.py: 2 steps of adamw, lr 1e-2, clip 1.0, on
# its B x T batch) on the card against the same step on the CPU, held to
# train_gap.TOL as tests/test_torch_train.py holds the CPU against JAX;
# then grad_accum = 2 and remat on for a dense and a recurrent arch
TRAIN_EXTRA = ({"grad_accum": 2}, {"remat": True})
TRAIN_EXTRA_ARCHS = ("qwen1.5-4b", "falcon-mamba-7b")
# phase 25: qwen1.5-4b at full width, whole (40 layers, grad_accum 4,
# remat on): 3 steps through launch/train.py's main
TRAIN_ARCH = "qwen1.5-4b"
TRAIN_FULL = ["--arch", TRAIN_ARCH, "--full", "--islands", "1", "--steps",
              "3", "--batch", "4", "--seq", "1024"]
# its first step's train-route loss against the same batch's loss with no
# gradient (the serving route: the flash_attention kernel, P in fp32),
# relative; near the geometric mean of the card's reading of that gap when
# the train route was attention_full (P in bf16), 2.14e-5, and a fault
# planted in the train route (each query sees one key ahead), 1.82e-3.
# The train route's forward is now the training kernels', whose o equals
# the prefill kernel's bit for bit, so the gap is what else differs.  A one-ulp nudge
# of every param reads 2.57e-4 and a loss mask one position longer
# 1.93e-5: at 4 x 1,024 positions one position is lost in the mean
# (PERF.md section 6; phase 25 prints all four)
TRAIN_ROUTE_TOL = 2e-4
# phase 26: the federated loop at full width cut to 4 of its 40 layers,
# 2 islands; per case its flags, quant8 launches (quantise, dequantise)
# over the run's 2 exchanges (one grouped launch a hop; the robust fold's
# wire is one an island) and the reference's tag sequence
TRAIN_FL_LAYERS = 4
TRAIN_FL = ["--arch", TRAIN_ARCH, "--full", "--islands", "2",
            "--local-steps", "2", "--steps", "4", "--batch", "4",
            "--seq", "1024"]
TRAIN_FL_CASES = {
    "q8": (["--compress", "q8"], (2, 2),
           ["local", "exchange+q8", "local", "exchange+q8"]),
    "q8 fog x2 overlap": (["--compress", "q8", "--fog-cells", "2",
                           "--overlap"], (4, 4),
                          ["local", "fog-exchange x2+q8+overlap",
                           "local+merge", "fog-exchange x2+q8"]),
    "q8-topk byzantine trimmed_mean": (
        ["--compress", "q8-topk", "--byzantine", "0.5", "--robust-agg",
         "trimmed_mean"], (4, 4),
        ["local", "robust-exchange:trimmed_mean+q8-topk", "local",
         "robust-exchange:trimmed_mean+q8-topk"])}
# islands after an exchange (tests/test_system.py's consensus check)
ISLAND_AGREE_TOL = 1e-5
# the planning layer (phases a-d): phase (a)'s bf16 product and device
# copy; phase (c)'s ServeLoop the policy sizes on one card (head/bf16 over
# the cap at 48 slots, head/int8 picked; head/bf16 at 32), its prompts
POLICY_SLOTS, POLICY_SMALL_SLOTS, POLICY_MAX_LEN = 48, 32, 32768
POLICY_LENGTHS, POLICY_NEW = (1, 77, 300, 2047), 16
MATMUL_N, COPY_BYTES = 8192, 4 * 10 ** 9


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
                b_ms, b_by = work_bound(fed_agg_work(
                    K, N, x.element_size(), x.element_size()))
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
    8 x 2^18 fp32); the scenario engine's async merge over its
    scenario-mlp's 4 leaves (K = 2); a mixed fp32 / bf16 tree, and a tree
    past a launch's capacity (its launches counted); beside them an empty
    kernel's graph time, the launch floor, and the async merge as the
    server calls it (`aggregation.async_merge`) in Python-call time.  ->
    the async merge's record."""
    from repro_torch import threefry
    from repro_torch.configs import get_config
    from repro_torch.core import aggregation, scenarios
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
    scenario_mlp = leaf_shapes(build_model(scenarios._DEFAULT_MODEL).init(
        threefry.key(0), torch.device("cuda")))
    errs.append(held("fl_scale async merge, scenario-mlp",
                     members(2, scenario_mlp), rng.dirichlet([1.0] * 2), 1))
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
    b_ms, b_by = work_bound(fed_agg_work(len(merge), n, 4, 4))
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
    for name, kern, plain, lib, work in (
            ("quantize", lambda: q8.quantize_rows_cuda(x),
             lambda: quantize_rows_ref(x), None,
             quant8_quantize_work(n, R, itemsize)),
            ("dequantize", lambda: q8.dequantize_rows_cuda(q, s, out_dtype),
             lambda: dequantize_rows_ref(q, s, out_dtype),
             (lambda: torch.mul(q, s)) if out_dtype == torch.float32
             else None,
             quant8_dequantize_work(n, R, out_size))):
        b_ms, b_by = work_bound(work)
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
    for name, grouped, singles, plain, library, work, err in (
            ("quantize", lambda: q8.quantize_grouped_cuda(xs),
             lambda: [q8.quantize_rows_cuda(x) for x in xs],
             lambda: quantize_rows_grouped_ref(xs), None,
             quant8_quantize_work(n, R, in_size), q_err),
            ("dequantize",
             lambda: q8.dequantize_grouped_cuda(qs, ss, out_dtype),
             lambda: [q8.dequantize_rows_cuda(q, s, out_dtype)
                      for q, s in zip(qs, ss)],
             lambda: dequantize_rows_grouped_ref(qs, ss, out_dtype), mul,
             quant8_dequantize_work(n, R, out_size), d_err)):
        b_ms, b_by = work_bound(work)
        nbytes = work[1]
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


def flash_sweep(torch):
    """flash_attention vs its plain version over FA_SWEEP x dtype and the
    FA_STRIDED views, each on the route kernel.route gives it; then
    granite-20b's and recurrentgemma-9b's full-width prefill shapes, the
    MoE archs' (FA_MOE) and phi-3-vision's and seamless-m4t's
    (FA_FAMILY), timed; -> their records, by arch (seamless-m4t's by arch
    and part)."""
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
    timed = {LM_ARCH: (*FA_MAIN, 0, True), HYBRID_ARCH: (*FA_HYBRID, True),
             **{arch: (*shape, True) for arch, shape in FA_MOE.items()},
             **FA_FAMILY}
    for arch, (B, T, H, Hkv, D, window, causal) in timed.items():
        q, k, v = qkv(B, T, H, Hkv, D, torch.bfloat16)
        check(route(q, k, v) == "wgmma", f"{arch} prefill attention route "
              f"{route(q, k, v)}")
        got = flash_attention_cuda(q, k, v, window=window, causal=causal)
        err = float((got.float() - plain(q, k, v, window, causal).float())
                    .abs().max())
        check(err <= FA_TOL["bfloat16"], f"flash_attention {arch} full "
              f"width: {err}")
        del got
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        ms = graph_ms(torch, lambda: flash_attention_cuda(
            q, k, v, window=window, causal=causal), 5)
        plain_ms = graph_ms(torch, lambda: plain(q, k, v, window, causal), 2)
        # the yardstick: is_causal=True is recurrentgemma's window of 2,048
        # at T = 2,048 (every key j <= t also has j > t - 2,048); a window
        # the prompt passes (mixtral's) is a boolean mask over K/V repeated
        # to every head
        if window in (0, T):
            lib_ms = graph_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True), 20)
        else:
            t = torch.arange(T, device="cuda")
            mask = (t[None] <= t[:, None]) & (t[None] > t[:, None] - window)
            kr, vr = (x.repeat_interleave(H // Hkv, dim=1) for x in (kt, vt))
            lib_ms = graph_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kr, vr, attn_mask=mask), 20)
            del kr, vr, mask
        work = flash_attention_work(B, T, T, H, Hkv, D, window, causal,
                                    q.dtype)
        (flops,), nbytes = work[0].values(), work[1]
        b_ms, b_by = work_bound(work)
        # P kept as hi + lo bf16 doubles the P V half of the tensor work
        split_ms, _ = work_bound(({"bfloat16": flops * 3 // 2}, nbytes))
        recs[arch] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      "library_ms": lib_ms, "bound_ms": b_ms,
                      "bound_by": b_by}
        print(f"flash_attention {arch} full width B={B} T={T} H={H} Hkv={Hkv}"
              f" D={D} window={window} bf16 causal={causal}, route wgmma: "
              f"{ms:.4f} ms "
              f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, "
              f"sdpa {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; "
              f"{flops:.4g} FLOPs, {nbytes / 1e9:.3f} GB; {b_ms / ms:.2%} of "
              f"it), with P split {split_ms:.4f} ms ({split_ms / ms:.2%} of "
              f"it), max |diff| {err:.3g}", flush=True)
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    return recs


def flash_train_sweep(torch) -> dict:
    """Phase 10b: the training kernels (flash_attention_train) over
    FA_TRAIN_SHAPES: o, dq, dk and dv against torch.autograd of
    attention_full in fp32 on the same bf16 values and against ref.py's
    blockwise backward, o + o_lo against the fp32 output, the lse against
    the plain one; the forward's o equal to the prefill kernel's bit for bit
    and a second backward equal to the first.  Then the first shape (the
    benchmark cell's) timed: the forward with its lse and the backward
    beside their bounds, the prefill forward, attention_full's forward and
    backward (the plain version) and scaled_dot_product_attention's
    (a yardstick only).  -> the records."""
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_attention import ref
    from repro_torch.models.layers import attention_full
    F = torch.nn.functional
    g = torch.Generator(device="cuda").manual_seed(3)

    def rel(a, b):
        a, b = a.detach().float(), b.detach().float()
        return float((a - b).abs().max() / b.abs().max())

    def draw(B, T, H, Hkv, D):
        return ((torch.randn(B, T, H, D, generator=g, device="cuda") * 0.5
                 ).bfloat16(),
                (torch.randn(B, T, Hkv, D, generator=g, device="cuda") * 0.5
                 ).bfloat16(),
                torch.randn(B, T, Hkv, D, generator=g, device="cuda"
                            ).bfloat16(),
                torch.randn(B, T, H, D, generator=g, device="cuda"
                            ).bfloat16())

    recs = {"shapes": {}}
    for shape in FA_TRAIN_SHAPES:
        B, T, H, Hkv, D, window, causal = shape
        q, k, v, do = draw(B, T, H, Hkv, D)
        kw = {"causal": causal, "window": window}
        check(fa.takes_grad(q, k, v), f"flash train {shape}: not taken")
        o, o_lo, lse = fa.flash_attention_train_fwd_cuda(q, k, v, **kw)
        grads = fa.flash_attention_train_bwd_cuda(q, k, v, o, o_lo, lse, do,
                                                  **kw)
        again = fa.flash_attention_train_bwd_cuda(q, k, v, o, o_lo, lse, do,
                                                  **kw)
        same_o = bool(torch.equal(o, fa.flash_attention_cuda(q, k, v, **kw)))
        same = all(bool(torch.equal(a, b)) for a, b in zip(grads, again))
        ins = [t.float().requires_grad_(True) for t in (q, k, v)]
        out = attention_full(*ins, **kw)
        want = torch.autograd.grad(out, ins, do.float())
        bhtd = [t.transpose(1, 2) for t in (q, k, v)]
        of, lse_ref = ref.attention_lse_ref(*bhtd, **kw)
        blockwise = ref.attention_bwd_ref(
            *bhtd, (o.float() + o_lo.float()).transpose(1, 2), lse[..., :T],
            do.transpose(1, 2), **kw)
        rec = {"o": rel(o, out),
               "o_fp32": rel(o.float() + o_lo.float(), of.transpose(1, 2)),
               "lse_abs": float((lse[..., :T] - lse_ref).abs().max()),
               "vs_attention_full": [rel(a, b) for a, b in zip(grads, want)],
               "vs_blockwise": [rel(a, b.transpose(1, 2))
                                for a, b in zip(grads, blockwise)],
               "same_bits": same, "o_equals_prefill": same_o}
        worst = max(rec["o"], *rec["vs_attention_full"],
                    *rec["vs_blockwise"])
        check(worst <= FA_TRAIN_TOL and rec["o_fp32"] <= 1e-4
              and rec["lse_abs"] <= 1e-4 and same and same_o,
              f"flash train {shape}: {rec}")
        print(f"flash_attention_train B={B} T={T} H={H} Hkv={Hkv} D={D} "
              f"window={window} causal={causal}: o {rec['o']:.3g}, dq dk dv "
              f"vs attention_full fp32 "
              f"{[round(x, 6) for x in rec['vs_attention_full']]}, vs the "
              f"blockwise ref {[round(x, 6) for x in rec['vs_blockwise']]} "
              f"(tol {FA_TRAIN_TOL}), o + o_lo {rec['o_fp32']:.3g}, lse "
              f"{rec['lse_abs']:.3g}, two backwards equal {same}, o equal to "
              f"the prefill kernel's {same_o}", flush=True)
        recs["shapes"]["x".join(map(str, shape))] = rec
        del q, k, v, do, o, o_lo, lse, grads, again, ins, out, want
        torch.cuda.empty_cache()
    B, T, H, Hkv, D, window, causal = FA_TRAIN_SHAPES[0]
    q, k, v, do = draw(B, T, H, Hkv, D)
    o, o_lo, lse = fa.flash_attention_train_fwd_cuda(q, k, v)
    fwd_ms = graph_ms(torch, lambda: fa.flash_attention_train_fwd_cuda(
        q, k, v), 10)
    prefill_ms = graph_ms(torch, lambda: fa.flash_attention_cuda(q, k, v), 10)
    bwd_ms = graph_ms(torch, lambda: fa.flash_attention_train_bwd_cuda(
        q, k, v, o, o_lo, lse, do), 10)
    ins = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]

    def plain():
        torch.autograd.grad(attention_full(*ins), ins, do)

    def sdpa():
        out = F.scaled_dot_product_attention(
            *(t.transpose(1, 2) for t in ins), is_causal=True)
        torch.autograd.grad(out, ins, do.transpose(1, 2))
    plain_ms = eager_ms(torch, plain, 5)
    lib_ms = eager_ms(torch, sdpa, 20)
    fw = flash_attention_train_fwd_work(B, T, H, Hkv, D, window, causal,
                                        q.dtype)
    bw = flash_attention_train_bwd_work(B, T, H, Hkv, D, window, causal,
                                        q.dtype)
    (fwd_b, fwd_by), (bwd_b, bwd_by) = work_bound(fw), work_bound(bw)
    bflops = bw[0]["bfloat16"]
    recs.update({"ms": bwd_ms, "fwd_ms": fwd_ms, "prefill_ms": prefill_ms,
                 "bound_ms": bwd_b, "bound_by": bwd_by, "fwd_bound_ms": fwd_b,
                 "plain_ms": plain_ms, "library_ms": lib_ms})
    print(f"flash_attention_train at the cell's shape B={B} T={T} H={H} "
          f"Hkv={Hkv} D={D} causal: forward with lse {fwd_ms:.4f} ms (the "
          f"prefill forward {prefill_ms:.4f}; bound {fwd_b:.4f}, {fwd_by}), "
          f"backward {bwd_ms:.4f} ms ({bflops / bwd_ms / 1e9:.1f} TFLOP/s of "
          f"{bflops:.4g} FLOPs; bound {bwd_b:.4f} ms, {bwd_by}, "
          f"{bwd_b / bwd_ms:.2%} of it); attention_full forward + backward "
          f"{plain_ms:.3f} ms, sdpa forward + backward {lib_ms:.4f} ms "
          f"(yardstick)", flush=True)
    del q, k, v, do, o, o_lo, lse, ins
    torch.cuda.empty_cache()
    return recs


def layer_counts(cfg) -> dict:
    """Launches of each kernel in one prefill of `cfg`'s model: flash for
    every attention layer, linrec for every recurrent (SSM, RG-LRU) one.
    The enc-dec's frames have the prompt's length here, so each decoder
    layer's cross attention (T == S) launches flash too."""
    if cfg.is_encdec:
        return {"flash_attention": cfg.enc_layers + 2 * cfg.num_layers,
                "linrec": 0}
    if cfg.family == "ssm":
        return {"flash_attention": 0, "linrec": cfg.num_layers}
    if cfg.family == "hybrid":
        from repro_torch.models.rglru import hybrid_counts
        n_super, n_tail = hybrid_counts(cfg)
        return {"flash_attention": n_super, "linrec": 2 * n_super + n_tail}
    return {"flash_attention": cfg.num_layers, "linrec": 0}


def attention_call_kinds(cfg) -> list:
    """The kind of each attention call of one prefill, in call order: the
    enc-dec's encoder layers first, then each decoder layer's self and
    cross attention."""
    if cfg.is_encdec:
        return ["encoder"] * cfg.enc_layers \
            + ["self", "cross"] * cfg.num_layers
    return ["self"] * layer_counts(cfg)["flash_attention"]


def decode_counts(cfg) -> dict:
    """Launches of each kernel in one decode step: linrec per recurrent
    layer; attention decodes without flash."""
    return {"flash_attention": 0, "linrec": layer_counts(cfg)["linrec"]}


def lm_serve(torch, arch: str, batch: int, layers: int = 0):
    """The serve entry point at full width, counted from zero; -> (its
    result, the launches of each kernel in that run, peak memory).  With
    `layers`, the arch's full-width config cut to that many layers is
    served through serve.serve_config, the body of serve.py's main."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    torch.cuda.reset_peak_memory_stats()
    for fn in serve.KERNELS.values():
        fn.launches = 0
        fn.routes.update(dict.fromkeys(fn.routes, 0))
    routes = serve.KERNELS["flash_attention"].routes
    lr_routes = serve.KERNELS["linrec"].routes
    argv = ["--arch", arch, "--full", "--batch", str(batch),
            "--prompt-len", str(LM_PROMPT), "--gen", str(LM_GEN)]
    t0 = time.perf_counter()
    if layers:
        res = serve.serve_config(dataclasses.replace(
            get_config(arch), num_layers=layers), serve.parse_args(argv))
    else:
        res = serve.main(argv)
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
    print(f"serve {arch} full width, {model.cfg.num_layers} layers "
          f"({model.n_params / 1e9:.2f} B params,"
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
    """A batch of LM_CHECK_BATCH x LM_PROMPT (serve.make_batch: tokens,
    and the VLM's patch embeddings or the enc-dec's frames) prefilled
    through the kernels, each layer's attention (the enc-dec's encoder,
    decoder self and cross attention) and scan output held against the
    plain version on the same inputs, then the whole prefill through the
    plain versions: last-position logits within the arch's
    LM_LOGITS_TOL.  An MoE model's routing is copied to the host in every
    layer of both prefills: the card's choices, positions and drops must
    equal moe_route's on the CPU from the same probabilities, bit for
    bit; the share of dropped choices and of tokens routed otherwise in
    the plain prefill are printed."""
    from repro_torch.kernels.linrec import ops as linrec_ops
    from repro_torch.launch.serve import make_batch
    from repro_torch.models import layers
    arch = model.cfg.name
    route, routed = layers.moe_route, {"kernels": [], "plain": []}

    def recorded_route(probs, k, C):
        out = route(probs, k, C)
        routed[run].append((probs.cpu(), k, C, [t.cpu() for t in out]))
        return out

    batch = make_batch(model.cfg, np.random.default_rng(1), LM_CHECK_BATCH,
                       LM_PROMPT, "cuda")
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
    layers.moe_route, run = recorded_route, "kernels"
    try:
        with torch.no_grad():
            lk, _ = model.apply(params, batch, mode="prefill")
            layers.select_attention, linrec_ops.linrec = select, scan
            run = "plain"
            lr, _ = model.apply(params, batch, mode="prefill", impl="ref")
    finally:
        layers.select_attention, linrec_ops.linrec = select, scan
        layers.moe_route = route
    tols = {"flash_attention": FA_TOL["bfloat16"],
            "linrec": LR_TOL["float32"]}
    routing = moe_routing_check(arch, routed) if routed["kernels"] else {}
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
    by_kind = {}     # the call counts are checked below
    for kind, err in zip(attention_call_kinds(model.cfg),
                         errs["flash_attention"]):
        by_kind[kind] = max(by_kind.get(kind, 0.0), err)
    if len(by_kind) > 1:
        per_layer += " (by kind: " + ", ".join(
            f"{kind} {err:.3g}" for kind, err in by_kind.items()) + ")"
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
    return {"layer_max_abs_err": layer_errs, "attention_by_kind": by_kind,
            "logits_rel": rel, **routing}


def moe_routing_check(arch, routed) -> dict:
    """Each layer's routing on the card against moe_route on the CPU from
    the same (copied) probabilities: gidx, pos and keep bit-equal.  ->
    the share of dropped choices and the share of tokens whose choices
    the plain prefill makes otherwise, by layer."""
    from repro_torch.models import layers
    dropped, parted = [], []
    for i, ((probs, k, C, card), (_, _, _, plain)) in enumerate(
            zip(routed["kernels"], routed["plain"])):
        cpu = layers.moe_route(probs, k, C)
        for name, got, want in zip(("gidx", "pos", "keep"), card[1:],
                                   cpu[1:]):
            check(got.equal(want), f"{arch} layer {i}: the card's "
                  f"routing {name} differs from the CPU's on the same "
                  "probabilities")
        dropped.append(float((~card[3]).float().mean()))
        parted.append(float((card[1] != plain[1]).any(-1).float().mean()))
    check(len(dropped) == len(routed["plain"]),
          f"{arch}: {len(dropped)} routed layers in the kernel prefill, "
          f"{len(routed['plain'])} in the plain one")
    print(f"{arch} routing, {len(dropped)} layers (k {k}, capacity {C} "
          f"a group): card == CPU from the same probabilities, bit for "
          f"bit (gidx, pos, keep); dropped choices by layer "
          f"{[round(d, 4) for d in dropped]}; tokens routed otherwise in "
          f"the plain prefill {[round(p, 5) for p in parted]}", flush=True)
    return {"dropped_share": dropped, "parted_share": parted}


def moe_layer_times(torch, model, params, card: str) -> dict:
    """One MoE layer (layer 0's params) at the serve's prefill and decode
    shapes, by part: router and routing, dispatch, the expert products,
    combine, and the whole layer; device time (CUDA graph), the expert
    products beside their bound (operations at bf16, the expert weights
    read once)."""
    from repro_torch.models import layers
    cfg = model.cfg
    E, k, d, f = (cfg.num_experts, cfg.experts_per_token, cfg.d_model,
                  cfg.moe_d_ff)
    p = {name: w[0] for name, w in params["layers"]["moe"].items()}
    g = torch.Generator(device="cuda").manual_seed(3)
    out = {}
    for label, T in (("prefill", LM_PROMPT), ("decode", 1)):
        x = torch.randn(MOE_BATCH, T, d, generator=g, device="cuda").to(
            torch.bfloat16)
        G = layers._moe_groups(MOE_BATCH, T)
        C = layers.moe_capacity(cfg, MOE_BATCH * T // G)
        xg = x.reshape(G, -1, d)
        gval, gidx, pos, keep = layers.moe_route(layers.moe_router(p, xg),
                                                 k, C)
        xe = layers.moe_dispatch(xg, gidx, pos, keep, E, C)
        ye = layers.moe_experts(p, cfg, xe)
        parts = {
            "route": lambda: layers.moe_route(layers.moe_router(p, xg), k, C),
            "dispatch": lambda: layers.moe_dispatch(xg, gidx, pos, keep, E,
                                                    C),
            "experts": lambda: layers.moe_experts(p, cfg, xe),
            "combine": lambda: layers.moe_combine(ye, gval, gidx, pos, keep,
                                                  C),
            "layer": lambda: layers.moe_apply(p, cfg, x)}
        ms = {name: graph_ms(torch, fn, 5) for name, fn in parts.items()}
        b_ms, b_by = work_bound(({"bfloat16": 6 * E * G * C * d * f},
                                 3 * E * d * f * 2))
        gathers = ms["route"] + ms["dispatch"] + ms["combine"]
        out[label] = {**ms, "experts_bound_ms": b_ms, "bound_by": b_by}
        print(f"{cfg.name} MoE layer, {label} {MOE_BATCH}x{T} (G {G}, C "
              f"{C}): " + ", ".join(f"{n} {t:.4f} ms" for n, t in ms.items())
              + f"; experts' bound {b_ms:.4f} ms ({b_by}, "
              f"{b_ms / ms['experts']:.2%} of it); router, routing, "
              f"dispatch and combine {gathers / ms['layer']:.2%} of the "
              f"layer ({card})", flush=True)
        del x, xg, xe, ye
    return out


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


def family_serve(torch, arch: str, card: str) -> dict:
    """phi-3-vision-4.2b or seamless-m4t-large-v2 at full width, counted
    from zero: the serve entry point at FAMILY_BATCH x LM_PROMPT, the
    kernels-vs-plain check prefill, then the ServeLoop: the VLM's drains
    FAMILY_LOOP_LENGTHS' text prompts, the enc-dec's must be refused (the
    reference's cannot serve it); -> the phase's record."""
    from repro_torch.launch.serve_loop import ServeLoop
    t0 = time.perf_counter()
    res, serve_launches, peak = lm_serve(torch, arch, FAMILY_BATCH)
    model, params = res["model"], res["params"]
    steps = res["decode_steps"]
    rec = {"serve": serve_launches, "peak_gb": peak,
           "prefill_ms": res["prefill_s"] * 1e3,
           "decode_ms": res["decode_s"] * 1e3 / steps}
    del res
    rec.update(lm_kernel_vs_plain(torch, model, params))
    if model.cfg.is_encdec:
        refusal = None
        try:
            ServeLoop(model, params, max_batch=LOOP_SLOTS,
                      max_len=LOOP_MAX_LEN)
        except NotImplementedError as err:
            refusal = str(err)
        check(refusal is not None, f"ServeLoop {arch}: not refused")
        print(f"ServeLoop {arch}: refused ({refusal})", flush=True)
    else:
        rec["loop"] = lm_serve_loop(torch, model, params,
                                    FAMILY_LOOP_LENGTHS)
    rec["wall_s"] = time.perf_counter() - t0
    print(f"{arch} full width, phase: prefill {FAMILY_BATCH}x{LM_PROMPT} "
          f"{rec['prefill_ms']:.1f} ms, decode {rec['decode_ms']:.2f} "
          f"ms/step, peak {peak:.2f} GB, {rec['wall_s']:.1f} s wall "
          f"({card})", flush=True)
    del model, params
    torch.cuda.empty_cache()
    return rec


def paged_serve(torch, card: str):
    """serve.py --paged at full width through its main, counted from zero;
    -> its result and the launches of each kernel in it."""
    from repro_torch.launch import serve
    torch.cuda.reset_peak_memory_stats()
    for fn in serve.KERNELS.values():
        fn.launches = 0
        fn.routes.update(dict.fromkeys(fn.routes, 0))
    t0 = time.perf_counter()
    res = serve.main(["--full", "--paged", "--batch", str(PAGED_BATCH),
                      "--prompt-len", str(PAGED_PROMPT), "--gen",
                      str(PAGED_GEN)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in serve.KERNELS.items()}
    loop, nb = res["loop"], res["pool"][0]
    check(res["requests"] == 2 * PAGED_BATCH and all(
        len(r.out) == PAGED_GEN and r.done for r in res["done"]),
        f"paged serve: {res['requests']} requests, lengths "
        f"{[len(r.out) for r in res['done']]}")
    loop.alloc.check_invariants()
    check(not loop.alloc.tables and loop.alloc.n_free() == nb
          and not any(loop.alloc.ref),
          f"paged serve: {loop.alloc.n_free()} of {nb} blocks free or "
          "cached once drained")
    check(launches == {"flash_attention": 0, "linrec": 0},
          f"paged serve: kernel launches {launches}; its prefill attention "
          "is the reference's plain route, so none is expected")
    for r in res["done"]:
        check(min(r.out) >= 0 and max(r.out) < res["model"].cfg.vocab_size,
              f"paged serve: request {r.rid} generated ids out of range")
    print(f"paged serve {LM_ARCH} full width ({card}): "
          f"{res['requests']} requests x {PAGED_GEN} tokens, pool "
          f"{nb}x{res['pool'][1]} ({nb * res['pool'][1]} positions), "
          f"{res['chunk_steps']} chunk steps, {res['decode_steps']} decode "
          f"steps, {res['decode_tick_ms']:.2f} ms per decode tick, "
          f"{res['tok_per_s']:.1f} tok/s, shared {res['shared_blocks']} "
          f"blocks, {res['preemptions']} preemptions, flash_attention "
          f"launches {launches['flash_attention']}, peak memory "
          f"{res['peak_gb']:.2f} GB, {wall:.1f} s wall", flush=True)
    return res, launches


def paged_vs_contiguous(torch, model, params, card: str) -> dict:
    """examples/serve_load's shared-prefix parity trace on the virtual
    clock at full width, through PagedServeLoop (invariants after every
    tick) and the contiguous ServeLoop, the logits behind every token
    recorded in both: held within serve_load.FULL_LOGITS_TOL of each
    other while the streams agree (the contiguous loop's first token is
    the request's solo prefill), partings only at near-ties."""
    from repro_torch.examples import serve_load
    from repro_torch.launch import loadgen
    tol = serve_load.FULL_LOGITS_TOL
    trace = loadgen.generate(serve_load._load_cfg(model.cfg.vocab_size,
                                                  shared=True))
    t0 = time.perf_counter()
    res = serve_load.parity(model, params, trace, tol=tol,
                            on_tick=lambda lp: lp.alloc.check_invariants())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(res["shared_blocks"] > 0, "parity trace shared no prefix block")
    check(res["mismatches"] == 0, f"paged vs contiguous: "
          f"{res['mismatches']} streams flagged {res['verdicts']}; logits "
          f"up to {res['logits_diff']} apart while the streams agree "
          f"(tol {tol})")
    chunks, ticks = res["paged_steps"]
    print(f"paged vs contiguous {LM_ARCH} full width ({card}), pool "
          f"{serve_load.POOL}, {res['n_requests']} requests on the virtual "
          f"clock: shared {res['shared_blocks']} blocks, "
          f"{res['preemptions']} preemptions, {chunks} chunk steps and "
          f"{ticks} decode ticks (contiguous: "
          f"{res['contiguous_decode_steps']}); logits scale-relative max "
          f"|diff| while the streams agree {res['logits_diff']:.4g}, at "
          f"first tokens {res['first_token_diff']:.4g} (tol {tol}); first "
          f"tokens equal to the solo prefill's {res['first_equal']}/"
          f"{res['n_requests']}; streams parting at a near-tie "
          f"{res['near_tie_streams']}, flagged {res['mismatches']}; "
          f"contiguous steps within twice the largest |diff| of a tie "
          f"{res['near_tie_share']:.2%}; {res['tokens_agree']}/"
          f"{res['tokens']} tokens agree; {wall:.1f} s wall", flush=True)
    return res


def res_device(params):
    """The device the params lie on (the card)."""
    from repro_torch.tree import leaves
    return leaves(params)[0].device


@contextlib.contextmanager
def held_quant8(torch):
    """Every grouped quant8 call inside the block is also run through the
    plain version on the same inputs; yields {"quantize": [...],
    "dequantize": [...]}, one (rows, max |diff|) a leaf, the differences
    left on the card until the caller reads them."""
    from repro_torch.kernels.quant8 import ops as q8ops
    held = {"quantize": [], "dequantize": []}
    quantize, dequantize = (q8ops.quantize_rows_grouped,
                            q8ops.dequantize_rows_grouped)

    def checked_quantize(xs, *, impl="auto"):
        out = quantize(xs, impl=impl)
        for (q, sc), (qr, sr) in zip(out, quantize(xs, impl="ref")):
            held["quantize"].append((q.shape[0], torch.maximum(
                (q.int() - qr.int()).abs().max().float(),
                (sc - sr).abs().max())))
        return out

    def checked_dequantize(qs, ss, *, out_dtype=torch.float32,
                           impl="auto"):
        out = dequantize(qs, ss, out_dtype=out_dtype, impl=impl)
        want = dequantize(qs, ss, out_dtype=out_dtype, impl="ref")
        for o, w in zip(out, want):
            held["dequantize"].append(
                (o.shape[0], (o.float() - w.float()).abs().max()))
        return out

    q8ops.quantize_rows_grouped = checked_quantize
    q8ops.dequantize_rows_grouped = checked_dequantize
    try:
        yield held
    finally:
        q8ops.quantize_rows_grouped = quantize
        q8ops.dequantize_rows_grouped = dequantize


def chunked_int8(torch, model, params, card: str) -> dict:
    """A CHUNK_BATCH x CHUNK_PROMPT batch through make_chunk_prefill_step
    in chunks of CHUNK_LEN into a head/int8 cache of CHUNK_CACHE
    positions, then CHUNK_STEPS decode steps, quant8 counted from zero
    around them and each of its grouped calls held bit for bit against
    the plain version on the same inputs (ref.py, at this path's shapes);
    against a one-shot prefill into the same spec and its own decode
    steps, under serve_load.divergence."""
    import dataclasses
    from repro_torch.examples import serve_load
    from repro_torch.kernels.quant8 import kernel as q8
    from repro_torch.launch.steps import (make_chunk_prefill_step,
                                          make_decode_step)
    from repro_torch.models import build_model
    from repro_torch.tree import tree_map
    tol = LM_LOGITS_TOL[LM_ARCH]
    spec = build_model(dataclasses.replace(model.cfg,
                                           cache_spec="head/int8"))
    rec = serve_load.LogitsRecorder(spec)
    chunk, decode = make_chunk_prefill_step(rec), make_decode_step(rec)
    B, T, C, L = CHUNK_BATCH, CHUNK_PROMPT, CHUNK_LEN, model.cfg.num_layers
    dev = res_device(params)
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, model.cfg.vocab_size, (B, T)).astype(np.int32), device=dev)

    def steps(nxt, cache):
        out, rows = [nxt.cpu()], [rec.logits[:, -1].float()]
        for i in range(CHUNK_STEPS):
            nxt, cache = decode(params, {
                "tokens": nxt[:, None].to(torch.int32),
                "positions": torch.full((B, 1), T + i, dtype=torch.int32,
                                        device=dev)}, cache)
            rows.append(rec.logits[:, -1].float())
            out.append(nxt.cpu())
        return torch.stack(out, 1).tolist(), rows

    cache = tree_map(lambda d: torch.zeros(d.shape, dtype=d.dtype,
                                           device=dev),
                     spec.cache_defs(B, CHUNK_CACHE))
    q8.quantize_grouped_cuda.launches = 0
    q8.dequantize_grouped_cuda.launches = 0
    with held_quant8(torch) as held:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for pos in range(0, T, C):
            nxt, cache = chunk(params, {
                "tokens": toks[:, pos:pos + C],
                "positions": torch.arange(pos, pos + C, dtype=torch.int32,
                                          device=dev)[None].expand(B, C),
                "last_index": torch.full((B,), C - 1, dtype=torch.int32,
                                         device=dev)}, cache)
        torch.cuda.synchronize()
        t_chunks = time.perf_counter() - t0
        got, got_rows = steps(nxt, cache)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {"quantize": q8.quantize_grouped_cuda.launches,
                "dequantize": q8.dequantize_grouped_cuda.launches}
    want_n = L * (T // C + CHUNK_STEPS)
    check(launches == {"quantize": want_n, "dequantize": want_n},
          f"chunked int8 prefill + {CHUNK_STEPS} steps: quant8 launches "
          f"{launches}; one grouped quantise (cache.write_kv) and one "
          f"grouped dequantise (cache.read_kv) per layer per chunk and step: "
          f"{want_n} each")
    errs, shapes = {}, {}
    for name, calls in held.items():
        # K and V: two leaves a call
        check(len(calls) == 2 * want_n, f"chunked int8: {len(calls)} "
              f"{name} leaves held against the plain version, expected "
              f"{2 * want_n}")
        errs[name] = float(torch.stack([e for _, e in calls]).max())
        shapes[name] = sorted({r for r, _ in calls})
        check(errs[name] == 0.0, f"chunked int8: quant8 {name} vs plain "
              f"max |diff| {errs[name]} at rows {shapes[name]}")
    chunk_logits = got_rows[0]
    check(bool(torch.isfinite(chunk_logits).all()),
          "chunked prefill: non-finite logits")
    del cache
    with torch.no_grad():
        one_logits, one_cache = spec.apply(params, {"tokens": toks},
                                           mode="prefill")
    rec.logits = one_logits
    want, want_rows = steps(torch.argmax(one_logits[:, -1].float(), -1),
                            one_cache)
    del one_cache
    rel = serve_load.scale_relative(chunk_logits, want_rows[0])
    check(rel <= tol, f"chunked vs one-shot int8 prefill logits: "
          f"scale-relative max |diff| {rel} > {tol}")
    verdicts = [serve_load.divergence(
        got[b], want[b], [r[b] for r in got_rows], [r[b] for r in want_rows],
        serve_load.FULL_LOGITS_TOL) for b in range(B)]
    check(all(kind != "mismatch" for kind, _ in verdicts),
          f"chunked vs one-shot decode streams {verdicts}: {got} vs {want}")
    agree = sum(a == b for g, w in zip(got, want) for a, b in zip(g, w))
    print(f"contiguous chunked prefill {LM_ARCH} full width ({card}): "
          f"{B}x{T} in {T // C} chunks of {C} into head/int8 "
          f"({CHUNK_CACHE} positions) in {t_chunks * 1e3:.1f} ms, then "
          f"{CHUNK_STEPS} decode steps; quant8 launches {launches} "
          f"({L} layers x ({T // C} chunks + {CHUNK_STEPS} steps)), each "
          f"held against the plain version: quantise rows {shapes['quantize']}"
          f" max |diff| {errs['quantize']}, dequantise rows "
          f"{shapes['dequantize']} max |diff| {errs['dequantize']}; last "
          f"chunk vs one-shot prefill logits scale-relative max |diff| "
          f"{rel:.4g} (tol {tol}); decode streams "
          f"{[(k, round(d, 4)) for k, d in verdicts]}, {agree}/"
          f"{B * (CHUNK_STEPS + 1)} tokens agree; {wall:.1f} s wall",
          flush=True)
    return {"launches": launches, "logits_rel": rel, "max_abs_err": errs,
            "streams": verdicts}


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
        work = linrec_work(B, T, D, a.element_size(), with_h0)
        b_ms, b_by = work_bound(work)
        nbytes = work[1]
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


def scenarios_path(torch, card: str) -> int:
    """The scenario engine on the card: fl_scale's cells against the JAX
    engine's streams, flight-cnn-mnist's async run at 10^5 workers through
    the kernel and the plain version, fl_faults' cells and invariants, the
    scenario fleet's resume, then where the 10^5-worker loop's time goes.
    -> fed_agg launches of the scenario runs (the profile's excepted)."""
    from repro_torch.configs import get_config
    from repro_torch.core.scenarios import ScenarioSim
    from repro_torch.examples import (fl_faults, fl_scale, profile_scenarios,
                                      resume)
    from repro_torch.kernels.fed_agg import kernel
    from repro_torch.tree import leaves
    cnn = get_config("flight-cnn-mnist")
    # cuDNN's first CNN calls, outside the counted and timed runs
    ScenarioSim(fl_scale.scenario(1_000), model_cfg=cnn,
                device="cuda").run_async(1)
    kernel.fed_agg_grouped_cuda.launches = 0
    t0 = time.perf_counter()
    scale, results = fl_scale.run_all("cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel.fed_agg_grouped_cuda.launches
    for name, cell in scale["cells"].items():
        res = results[name]
        best, digest, n_records, last = JAX_FL_SCALE[name]
        r = res.records[-1]
        got = (fl_scale.stream_digest(res), len(res.records),
               (r.time, r.round, r.n_selected, r.version))
        merges = r.version if name.startswith("async") else 0
        print(f"fl_scale {name}: {cell['wall_s']} s wall ({card}), best "
              f"accuracy {res.best_acc} (JAX {best}), stream {got[0]} "
              f"(JAX {digest}), last record {got[2]}, "
              f"{cell['fed_agg_launches']} fed_agg launches", flush=True)
        check(got == (digest, n_records, last), f"fl_scale {name}: record "
              f"stream {got} differs from the JAX engine's "
              f"{(digest, n_records, last)}")
        check(abs(res.best_acc - best) <= SCENARIO_ACC_TOL,
              f"fl_scale {name}: best accuracy {res.best_acc} outside "
              f"{best}+-{SCENARIO_ACC_TOL}")
        check(cell["fed_agg_launches"] == merges, f"fl_scale {name}: "
              f"{cell['fed_agg_launches']} fed_agg launches in {merges} "
              "merges")
        for leaf in leaves(res.final_params):
            check(bool(torch.isfinite(leaf).all()),
                  f"fl_scale {name}: non-finite final params")
    # one warm-up merge per population size besides the cells
    expected = sum(c["fed_agg_launches"] for c in scale["cells"].values()) \
        + len(fl_scale.WORKERS)
    check(launches == expected, f"fl_scale made {launches} fed_agg "
          f"launches, {expected} expected")
    print(f"fl_scale: {wall:.3f} s wall for its four cells and warm-ups "
          f"({card}), {launches} fed_agg launches", flush=True)

    runs = {impl: fl_scale.run_cell(100_000, "async", "cuda", model_cfg=cnn,
                                    impl=impl) for impl in ("auto", "ref")}
    (rk, wk, nk), (rr, wr, nr) = runs["auto"], runs["ref"]
    pk, pr = leaves(rk.final_params), leaves(rr.final_params)
    err = max(float((a - b).abs().max()) for a, b in zip(pk, pr))
    n_params = sum(p.numel() for p in pk)
    print(f"flight-cnn-mnist ({n_params} params in {len(pk)} leaves), "
          f"10^5 workers, {fl_scale.ASYNC_MERGES} async merges: kernel "
          f"{wk:.3f} s, plain {wr:.3f} s wall ({card}); best accuracy "
          f"{rk.best_acc} and {rr.best_acc}; final params max |diff| {err}; "
          f"fed_agg launches {nk} and {nr}", flush=True)
    check((n_params, len(pk)) == (20_490, 6), "flight-cnn-mnist's tree")
    check(rk.records == rr.records and err == 0.0 and all(
        torch.equal(a, b) for a, b in zip(pk, pr)),
        "flight-cnn-mnist scenario: kernel and plain merges differ")
    check(nk == rk.records[-1].version == fl_scale.ASYNC_MERGES and nr == 0,
          f"flight-cnn-mnist scenario: fed_agg launches {nk} (kernel), "
          f"{nr} (plain) in {rk.records[-1].version} merges")
    launches += nk

    faults = fl_faults.run_all("cuda")
    for name, cell in faults["cells"].items():
        print(f"fl_faults {name}: best accuracy {cell['best_acc']} (JAX "
              f"{JAX_FL_FAULTS[name][0]}), final {cell['final_acc']}, "
              f"finite {cell['params_finite']}, quarantined "
              f"{cell['n_quarantined']} (JAX {JAX_FL_FAULTS[name][1]}), "
              f"{cell['wall_s']} s wall ({card})", flush=True)
        check(cell["n_quarantined"] == JAX_FL_FAULTS[name][1],
              f"fl_faults {name}: {cell['n_quarantined']} quarantined")
    failures = fl_faults.check_invariants(faults)
    check(not failures, f"fl_faults invariants: {failures}")
    for name in SCENARIO_HELD:
        best = round(JAX_FL_FAULTS[name][0], 4)    # the record's rounding
        got = faults["cells"][name]["best_acc"]
        check(abs(got - best) <= SCENARIO_ACC_TOL, f"fl_faults {name}: "
              f"best accuracy {got} outside {best}+-{SCENARIO_ACC_TOL}")

    with tempfile.TemporaryDirectory() as d:
        for mode in ("sync", "async"):
            before = kernel.fed_agg_grouped_cuda.launches
            ref, killed, resumed, merges = resume.scenario_crash_and_resume(
                mode, d, "cuda")
            torch.cuda.synchronize()
            n = kernel.fed_agg_grouped_cuda.launches - before
            check(resume.holds(ref, killed, resumed),
                  f"scenario {mode} resume differs from the uninterrupted "
                  "run")
            check(n == (merges if mode == "async" else 0),
                  f"scenario {mode} resume: {n} fed_agg launches")
            launches += n
            print(f"scenario resume {mode}: killed after "
                  f"{len(killed.records)} records at "
                  f"{'round' if mode == 'sync' else 'merge'} "
                  f"{resume.SCENARIO_CRASH_AT[mode]}, resumed "
                  f"{len(resumed.records)}: equal to the uninterrupted "
                  f"{len(ref.records)} records and its final params bit for "
                  f"bit; {n} fed_agg launches", flush=True)

    profile_scenarios.main([])
    return launches


def train_kernel_counts() -> dict:
    """Launches of the kernels a train step must not reach (the prefill
    flash_attention, linrec), of the training kernels and of the
    exchange's quant8, and the gradient-carrying attention calls that took
    the plain route, read now."""
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.linrec.kernel import linrec_cuda
    from repro_torch.kernels.quant8 import kernel as q8
    from repro_torch.models.layers import select_attention
    return {"flash_attention": fa.flash_attention_cuda.launches,
            "linrec": linrec_cuda.launches,
            "quantize": q8.quantize_grouped_cuda.launches,
            "dequantize": q8.dequantize_grouped_cuda.launches,
            "train_fwd": fa.flash_attention_train_fwd_cuda.launches,
            "train_bwd": fa.flash_attention_train_bwd_cuda.launches,
            "plain_grad": select_attention.grad_routes["plain"]}


def zero_train_counts():
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.linrec.kernel import linrec_cuda
    from repro_torch.kernels.quant8 import kernel as q8
    from repro_torch.models.layers import select_attention
    for fn in (fa.flash_attention_cuda, linrec_cuda,
               q8.quantize_grouped_cuda, q8.dequantize_grouped_cuda,
               fa.flash_attention_train_fwd_cuda,
               fa.flash_attention_train_bwd_cuda):
        fn.launches = 0
    select_attention.grad_routes.update(kernel=0, plain=0)


def train_attention_launches(cfg, steps: int, islands: int = 1) -> dict:
    """The training kernels' launches `steps` train steps of `islands`
    islands make: per microbatch and attention layer one backward and one
    forward, two under remat (its recompute)."""
    bwd = steps * islands * cfg.grad_accum * cfg.num_layers
    return {"train_fwd": bwd * (2 if cfg.remat else 1), "train_bwd": bwd}


def train_smoke(torch) -> dict:
    """Phase 24: every smoke arch's train step on the card against the
    same step on the CPU (train_gap.run_steps: the same params, drawn from
    the Threefry key of seed 0, and batch), held to train_gap.TOL; counted
    from zero: no flash_attention (prefill or training: the smoke heads of
    8 to 16 are below what the training kernels take), linrec or quant8
    launch."""
    import dataclasses
    from repro_torch import threefry
    from repro_torch.configs import get_smoke_config, list_archs
    from repro_torch.examples import train_gap
    from repro_torch.models import build_model
    from repro_torch.tree import tree_map
    cases = [(arch, {}) for arch in list_archs()] + [
        (arch, kw) for kw in TRAIN_EXTRA for arch in TRAIN_EXTRA_ARCHS]
    worst, launches = {}, {}
    t0 = time.perf_counter()
    zero_train_counts()
    for arch, kw in cases:
        cfg = dataclasses.replace(get_smoke_config(arch), **kw)
        model = build_model(cfg)
        params = model.init(threefry.key(0), "cpu")
        batch = train_gap.train_batch(model, train_gap.BATCH * cfg.grad_accum,
                                      train_gap.SEQ)
        cpu = train_gap.run_steps(model, params,
                                  train_gap.to_torch(batch, model, "cpu"))
        card = train_gap.run_steps(
            model, tree_map(lambda t: t.cuda(), params),
            train_gap.to_torch(batch, model, "cuda"))
        torch.cuda.synchronize()
        card = (tree_map(lambda t: t.cpu(), card[0]),
                tree_map(lambda t: t.cpu(), card[1]), card[2])
        g = train_gap.gaps(params, cpu, card)
        bad = train_gap.violations(cfg, g)
        label = arch + "".join(f" {k}={v}" for k, v in kw.items())
        check(not bad, f"train step {label}, card vs CPU: {bad} outside "
              f"train_gap.TOL: {g}")
        for k, v in g.items():
            worst[k] = max(worst.get(k, v), v) if k != "slope_min" \
                else min(worst.get(k, v), v)
        print(f"train step {label} (2 steps, card vs CPU): "
              + ", ".join(f"{k} {v:.3g}" for k, v in g.items()), flush=True)
    launches = train_kernel_counts()
    launches.pop("plain_grad")
    check(launches == dict.fromkeys(launches, 0),
          f"smoke train steps launched {launches}; none expected (the "
          "gradient routes are plain)")
    print(f"phase 24: {len(cases)} smoke train runs on the card, worst "
          + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
          + f", launches {launches}, {time.perf_counter() - t0:.1f} s",
          flush=True)
    return {"cases": len(cases), "worst": worst, "launches": launches}


def step_loss(torch, model, params, batch, accum: int, *,
              grad: bool) -> float:
    """The train step's loss (the mean of `accum` microbatch losses) on
    the serving route (no gradient: flash_attention) or, with `grad`, on
    the train route (every param a leaf that requires grad, as the train
    step makes them, so attention takes flash_attention_train's forward;
    no backward)."""
    from repro_torch.launch import steps
    total = torch.zeros((), device="cuda")
    tree = steps.grad_view(params)[0] if grad else params
    with torch.set_grad_enabled(grad):
        for j in range(accum):
            mb = {k: v.reshape((accum, -1) + v.shape[1:])[j]
                  for k, v in batch.items()}
            total = total + steps.lm_loss(model, tree, mb)[0].detach() \
                / accum
    return float(total)


@contextlib.contextmanager
def future_leak():
    """A planted fault in the train route: every causal attention call
    lets each query see one key past its own position (a query offset of
    one, which the plain route takes)."""
    from repro_torch.models import layers
    orig = layers.select_attention

    def leaky(q, k, v, *, causal=True, window=0, q_offset=0, impl="auto"):
        return orig(q, k, v, causal=causal, window=window,
                    q_offset=q_offset + 1 if causal else q_offset, impl=impl)

    layers.select_attention = leaky
    try:
        yield
    finally:
        layers.select_attention = orig


def adamw_slice_check(torch, params, opt_state, lr_fn) -> dict:
    """One layer slice of each stacked leaf (the middle layer) with its
    trained moments and a drawn gradient, stepped by the port's in-place
    adamw on the card and on the CPU: moments within 1e-6 of the CPU's,
    relative to the leaf's scale, params within one bf16 ulp."""
    from repro_torch.optim import adamw
    from repro_torch.tree import leaves
    stack = params["layers"]
    mid = leaves(stack)[0].shape[0] // 2
    g = torch.Generator(device="cuda").manual_seed(5)
    trees = (stack, opt_state["mu"]["layers"], opt_state["nu"]["layers"])
    sides = {dev: ([[t[mid].to(dev).clone() for t in ls]
                    for ls in zip(*map(leaves, trees))],
                   {"count": opt_state["count"].to(dev).clone()})
             for dev in ("cuda", "cpu")}
    grads = [torch.randn(p.shape, generator=g, device="cuda").mul_(1e-3)
             .to(p.dtype) for p, _, _ in sides["cuda"][0]]
    for dev, (pieces, state) in sides.items():
        adamw(lr_fn).step_([(p, gr.to(dev), m, v) for (p, m, v), gr
                            in zip(pieces, grads)], state,
                           grad_scale=torch.tensor(0.5, device=dev))
    moment_err, param_ulps, equal, n = 0.0, 0.0, 0, 0
    for (pc, mc, vc), (pp, mp, vp) in zip(sides["cuda"][0], sides["cpu"][0]):
        for a, b in ((mc, mp), (vc, vp)):
            moment_err = max(moment_err, float((a.cpu() - b).abs().max())
                             / max(float(b.abs().max()), 1e-30))
        a, b = pc.cpu().float(), pp.float()
        ulp = b.abs() * 2.0 ** -7 + 1e-30
        param_ulps = max(param_ulps, float(((a - b).abs() / ulp).max()))
        equal += int((a == b).sum())
        n += b.numel()
    check(moment_err <= 1e-6 and param_ulps <= 1.0,
          f"adamw on the card vs the CPU: moments {moment_err}, params "
          f"{param_ulps} bf16 ulps")
    return {"moment_rel": moment_err, "param_ulps": param_ulps,
            "param_equal_share": equal / n, "layer": mid,
            "leaves": len(grads)}


def train_full(torch, card: str) -> dict:
    """Phase 25: qwen1.5-4b at full width, whole, through launch/train.py's
    main (3 steps, grad_accum 4, remat), counted from zero (every
    gradient-carrying attention call on the training kernels); the step time,
    tokens/s, share of the dense bf16 peak (6 N tokens), peak memory; the
    adamw update against the CPU's; the first step's train-route loss
    against the serving route's on the same batch, beside the train
    route's under a planted fault (a query seeing one key ahead), a
    one-ulp nudge of every param and a loss mask one position longer."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import (batch_token_stream,
                                            make_token_stream)
    from repro_torch.examples import train_gap
    from repro_torch.launch import train
    from repro_torch.models import build_model
    from repro_torch.models.param import init_params_on_device
    from repro_torch.optim import cosine_warmup
    args = train.parse_args(TRAIN_FULL)
    cfg = get_config(TRAIN_ARCH)
    model = build_model(cfg)
    n_params = model.n_params
    tokens = args.batch * args.seq
    torch.cuda.reset_peak_memory_stats()
    zero_train_counts()
    t0 = time.perf_counter()
    res = train.main(TRAIN_FULL)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = train_kernel_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    want = {**dict.fromkeys(launches, 0),
            **train_attention_launches(cfg, args.steps)}
    check(launches == want,
          f"train.py --full {TRAIN_ARCH}: launches {launches}, expected "
          f"{want}")
    check(len(res["losses"]) == args.steps
          and all(np.isfinite(res["losses"])),
          f"train.py --full {TRAIN_ARCH}: losses {res['losses']}")
    check(peak < 80, f"train.py --full: peak {peak:.2f} GB")
    rows = []
    for s, (ms, loss) in enumerate(zip(res["step_ms"], res["losses"])):
        rate = tokens / (ms / 1e3)
        share = 6 * n_params * rate / BF16_FLOPS_PER_S
        rows.append({"step": s + 1, "ms": ms, "tokens_per_s": rate,
                     "peak_share": share, "loss": loss})
        print(f"train {TRAIN_ARCH} full width ({n_params:,} params, "
              f"grad_accum {cfg.grad_accum}, remat {cfg.remat}) step {s + 1}:"
              f" {ms:.1f} ms, {rate:,.0f} tokens/s, {share:.4f} of the "
              f"dense bf16 peak (6 N tokens), loss {loss:.4f} ({card})",
              flush=True)
    adam = adamw_slice_check(torch, res["params"], res["opt_state"],
                             cosine_warmup(args.lr, 10, args.steps))
    print(f"adamw on the card vs the CPU port, layer {adam['layer']} of "
          f"{adam['leaves']} stacked leaves: moments max rel "
          f"{adam['moment_rel']:.3g}, params max {adam['param_ulps']:.3g} "
          f"bf16 ulps ({adam['param_equal_share']:.6f} equal)", flush=True)
    train_loss = res["losses"][0]
    del res
    torch.cuda.empty_cache()
    # the first batch again, the initial params drawn again from the seed
    stream = make_token_stream(cfg.vocab_size, 400_000, seed=args.seed)
    x, y = batch_token_stream(stream, args.batch, args.seq, 0)
    batch = {"tokens": torch.as_tensor(x, device="cuda"),
             "labels": torch.as_tensor(y, device="cuda")}
    params = init_params_on_device(args.seed, model.param_defs(), "cuda")
    before = train_kernel_counts()["flash_attention"]
    served = step_loss(torch, model, params, batch, cfg.grad_accum,
                       grad=False)
    n_flash = train_kernel_counts()["flash_attention"] - before
    check(n_flash == cfg.grad_accum * cfg.num_layers,
          f"no-grad loss: {n_flash} flash launches")
    readings = {"train_route": train_loss}
    with future_leak():
        readings["future_leak"] = step_loss(torch, model, params, batch,
                                            cfg.grad_accum, grad=True)
    with train_gap.mask_shift():
        readings["mask_shift"] = step_loss(torch, model, params, batch,
                                           cfg.grad_accum, grad=True)
    train_gap.nudge_ulp_(params)
    readings["nudge"] = step_loss(torch, model, params, batch,
                                  cfg.grad_accum, grad=True)
    check(train_kernel_counts()["flash_attention"] == before + n_flash,
          "a train-route loss launched the prefill flash_attention")
    del params
    torch.cuda.empty_cache()
    rel = {k: abs(v - served) / abs(served) for k, v in readings.items()}
    print(f"{TRAIN_ARCH} first step's loss: train route {train_loss:.6f}, "
          f"serving route (flash, no grad) {served:.6f}; relative gaps "
          + ", ".join(f"{k} {v:.3g}" for k, v in rel.items())
          + f" (tolerance {TRAIN_ROUTE_TOL}; {card})", flush=True)
    check(rel["train_route"] <= TRAIN_ROUTE_TOL,
          f"train-route loss {train_loss} vs serving route {served}: "
          f"{rel['train_route']} > {TRAIN_ROUTE_TOL}")
    print(f"phase 25: {wall:.1f} s wall for train.py, peak {peak:.2f} GB "
          f"({card})", flush=True)
    return {"steps": rows, "peak_gb": peak, "wall_s": wall, "adamw": adam,
            "loss_gaps": rel, "launches": launches}


def digest(torch, tree) -> list:
    """Two int64 checksums of each leaf's bits (their sum, and their sum
    weighted by position mod 1009): equal digests hold two trees equal bit
    for bit without a second copy of either."""
    from repro_torch.tree import leaves
    bits = {torch.bfloat16: torch.int16, torch.float32: torch.int32,
            torch.int32: torch.int32}
    out = []
    for t in leaves(tree):
        b = t.contiguous().view(-1).view(bits[t.dtype]).long()
        w = torch.arange(b.numel(), device=b.device) % 1009 + 1
        out.append((int(b.sum()), int((b * w).sum())))
    return out


def train_fl(torch, card: str) -> dict:
    """Phase 26: launch/train.py's federated loop at full width cut to
    TRAIN_FL_LAYERS layers, 2 islands, under each TRAIN_FL_CASES config,
    counted from zero: quant8 launches by hop, each call held bit for bit
    against the plain version, the tags, the islands' agreement after the
    last exchange; then the q8 run killed after step 2 and resumed from
    its checkpoint, equal to the uninterrupted run bit for bit under
    torch.use_deterministic_algorithms."""
    import dataclasses
    import os
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models import build_model
    from repro_torch.tree import leaves
    cfg = dataclasses.replace(get_config(TRAIN_ARCH),
                              num_layers=TRAIN_FL_LAYERS)
    n_params = build_model(cfg).n_params
    steps = train.parse_args(TRAIN_FL).steps
    # cuBLAS refuses deterministic mode without a fixed workspace setting
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    out, q8_total = {}, {"quantize": 0, "dequantize": 0}
    try:
        whole = None
        for name, (extra, want_q8, want_tags) in TRAIN_FL_CASES.items():
            torch.cuda.reset_peak_memory_stats()
            zero_train_counts()
            t0 = time.perf_counter()
            with held_quant8(torch) as held:
                res = train.main(TRAIN_FL + extra, cfg=cfg)
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n = train_kernel_counts()
            peak = torch.cuda.max_memory_allocated() / 1e9
            want_fa = train_attention_launches(cfg, steps, islands=2)
            check((n["quantize"], n["dequantize"]) == want_q8
                  and n["flash_attention"] == n["linrec"] == 0
                  and n["plain_grad"] == 0
                  and {k: n[k] for k in want_fa} == want_fa,
                  f"train loop {name}: launches {n}, quant8 {want_q8} and "
                  f"training kernels {want_fa} expected, no prefill flash, "
                  "linrec or plain attention")
            errs = {k: float(torch.stack([e for _, e in v]).max())
                    for k, v in held.items()}
            check(all(e == 0.0 for e in errs.values()),
                  f"train loop {name}: quant8 vs plain {errs}")
            check(res["tags"] == want_tags,
                  f"train loop {name}: tags {res['tags']}, the reference's "
                  f"{want_tags}")
            check(all(np.isfinite(res["losses"])),
                  f"train loop {name}: losses {res['losses']}")
            agree = max(float((l[0].float() - l[1].float()).abs().max())
                        for l in leaves(res["params"]))
            check(agree <= ISLAND_AGREE_TOL,
                  f"train loop {name}: islands differ by {agree}")
            for k in q8_total:
                q8_total[k] += n[k]
            if name == "q8":
                whole = digest(torch, {"p": res["params"],
                                       "s": res["opt_state"]})
            out[name] = {"losses": res["losses"], "step_ms": res["step_ms"],
                         "peak_gb": peak, "quant8": n, "held_calls":
                         {k: len(v) for k, v in held.items()},
                         "island_gap": agree, "wall_s": wall}
            print(f"train loop {name}, {TRAIN_ARCH} full width cut to "
                  f"{TRAIN_FL_LAYERS} layers ({n_params:,} params an "
                  f"island), 2 islands: losses "
                  f"{[round(x, 4) for x in res['losses']]}, step ms "
                  f"{[round(x, 1) for x in res['step_ms']]}, tags "
                  f"{res['tags']}, quant8 {want_q8} (each of "
                  f"{sum(len(v) for v in held.values())} leaves bit-equal to "
                  f"the plain version), islands agree to {agree}, peak "
                  f"{peak:.2f} GB, {wall:.1f} s ({card})", flush=True)
            del res
            torch.cuda.empty_cache()
        # killed after step 2 (its checkpoint), then resumed to step 4
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as d:
            ck = ["--compress", "q8", "--ckpt-dir", d, "--ckpt-every", "2"]
            at = TRAIN_FL.index("--steps") + 1
            train.main(TRAIN_FL[:at] + ["2"] + TRAIN_FL[at + 1:] + ck,
                       cfg=cfg)
            torch.cuda.empty_cache()
            # no second checkpoint: one is 26.3 GB (bf16 params kept as
            # fp32, adamw's moments), and a run's disk writes add up
            res = train.main(TRAIN_FL + ["--compress", "q8", "--ckpt-dir", d,
                                         "--ckpt-every", "100", "--resume"],
                             cfg=cfg)
            resumed = digest(torch, {"p": res["params"],
                                     "s": res["opt_state"]})
            check(res["start"] == 2, f"resumed at step {res['start']}")
        del res
        torch.cuda.empty_cache()
        same = sum(a == b for a, b in zip(whole, resumed))
        check(same == len(whole), f"killed + resumed vs uninterrupted q8 "
              f"run: {len(whole) - same} of {len(whole)} leaves differ")
        print(f"train loop q8 killed after step 2 and resumed from its "
              f"checkpoint: params and adamw state equal to the "
              f"uninterrupted run's bit for bit ({len(whole)} leaves, "
              f"deterministic algorithms), "
              f"{time.perf_counter() - t0:.1f} s ({card})", flush=True)
    finally:
        torch.use_deterministic_algorithms(False)
    return {"cases": out, "quant8": q8_total, "n_params": n_params}


# -- the planning layer (phases a-d) ------------------------------------------

def hardware_check(torch, card: str) -> dict:
    """Phase (a): the hardware model (dist/hardware.py) against the card:
    a bf16 torch.matmul of MATMUL_N^3 and a COPY_BYTES device-to-device
    copy (read once, written once) in CUDA-graph time, neither of which
    may read above its constant (a roofline share above 100 % otherwise),
    and the card's memory beside DEVICE_HBM_BYTES."""
    n = MATMUL_N
    g = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn(n, n, generator=g, device="cuda").to(torch.bfloat16)
    b = torch.randn(n, n, generator=g, device="cuda").to(torch.bfloat16)
    mm_ms = graph_ms(torch, lambda: torch.matmul(a, b), 20)
    mm_rate = 2 * n ** 3 / (mm_ms / 1e3)
    del a, b
    src = torch.ones(COPY_BYTES, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    cp_ms = graph_ms(torch, lambda: dst.copy_(src), 10)
    cp_rate = 2 * COPY_BYTES / (cp_ms / 1e3)
    check(torch.equal(dst[-1024:], src[-1024:]), "device copy wrong")
    del src, dst
    torch.cuda.empty_cache()
    total = torch.cuda.get_device_properties(0).total_memory
    print(f"phase (a), the hardware model against the card ({card}): bf16 "
          f"matmul {n}^3 {mm_ms:.4f} ms = {mm_rate / 1e12:.1f} TFLOP/s "
          f"({mm_rate / BF16_FLOPS_PER_S:.2%} of the model's "
          f"{BF16_FLOPS_PER_S / 1e12:.0f}); a {COPY_BYTES / 1e9:.0f} GB "
          f"device copy {cp_ms:.4f} ms = {cp_rate / 1e12:.3f} TB/s read + "
          f"written ({cp_rate / HBM_BYTES_PER_S:.2%} of "
          f"{HBM_BYTES_PER_S / 1e12:.2f}); total_memory {total:,} B beside "
          f"DEVICE_HBM_BYTES {DEVICE_HBM_BYTES:,.0f}", flush=True)
    check(mm_rate <= BF16_FLOPS_PER_S, f"bf16 matmul {mm_rate:.4g} FLOP/s "
          f"above the model's {BF16_FLOPS_PER_S:.4g}")
    check(cp_rate <= HBM_BYTES_PER_S, f"device copy {cp_rate:.4g} B/s "
          f"above the model's {HBM_BYTES_PER_S:.4g}")
    return {"matmul_ms": mm_ms, "matmul_flops_per_s": mm_rate,
            "copy_ms": cp_ms, "copy_bytes_per_s": cp_rate,
            "total_memory": total}


def tree_bytes(tree) -> int:
    from repro_torch.tree import leaves
    return sum(t.numel() * t.element_size() for t in leaves(tree))


def decision_check(torch, res, card: str) -> dict:
    """Phase (b): phase 11's serve went through serve.pick_layout: the
    decision is stationary+head/bf16 and its predicted param and cache
    bytes are the drawn params' and the allocated cache's, exactly."""
    d = res["decision"]
    p_pred, c_pred = d.chosen.detail["param_bytes"], \
        d.chosen.detail["cache_bytes"]
    p_real, c_real = tree_bytes(res["params"]), tree_bytes(res["cache"])
    print(f"phase (b), serve.py's decision ({card}): {d.key}, predicted "
          f"params {p_pred:,.0f} B (drawn {p_real:,} B), cache "
          f"{c_pred:,.0f} B (allocated {c_real:,} B), peak "
          f"{d.chosen.hbm_bytes / 1e9:.2f} GB predicted beside "
          f"{res['peak_gb']:.2f} GB measured (max_memory_allocated) -- "
          f"{d.reason}", flush=True)
    check(d.key == "stationary+head/bf16", f"serve.py decided {d.key}")
    check(p_pred == p_real, f"predicted param bytes {p_pred} != {p_real}")
    check(c_pred == c_real, f"predicted cache bytes {c_pred} != {c_real}")
    return {"key": d.key, "predicted_gb": d.chosen.hbm_bytes / 1e9,
            "measured_gb": res["peak_gb"]}


def policy_loop(torch, model, params, card: str) -> dict:
    """Phase (c): granite-20b in a ServeLoop the policy sizes on the host
    mesh, POLICY_SLOTS x POLICY_MAX_LEN: the decision must be
    stationary+head/int8 (head/bf16 over the cap), the allocated cache its
    predicted bytes exactly; POLICY_LENGTHS prompts drained with
    POLICY_NEW tokens each, counted from zero and by path (each admitted
    prefill: one flash launch and one grouped quantise a layer; each
    decode step: one grouped quantise (cache.write_kv) and dequantise
    (cache.read_kv) a layer), every quant8 call held bit for bit against
    the plain version, each first token its solo prefill's; then the same
    prompts again, unchecked, for the peak, which must stay under
    DEVICE_HBM_BYTES; then POLICY_SMALL_SLOTS slots, which must decide
    head/bf16, one request admitted and its peak read the same way."""
    from repro_torch.dist.hardware import memory_dict
    from repro_torch.dist.policy import decide, eval_from_measured
    from repro_torch.kernels.quant8 import kernel as q8
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.serve_loop import Request, ServeLoop
    from repro_torch.launch.steps import make_prefill_step
    flash = serve.KERNELS["flash_attention"]
    L = model.cfg.num_layers
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, model.cfg.vocab_size, n).astype(np.int32)
               for n in POLICY_LENGTHS]

    def counts():
        return {"flash_attention": flash.launches,
                "quantize": q8.quantize_grouped_cuda.launches,
                "dequantize": q8.dequantize_grouped_cuda.launches}

    def drain(loop, reqs):
        for r in reqs:
            loop.submit(r)
        done = {r.rid: r.out for r in loop.run_until_drained()}
        torch.cuda.synchronize()
        return done

    def measured(d):
        """The chosen candidate as the card measured it: its allocator
        peak (memory_dict), scored against the same budget."""
        m = eval_from_measured(d.layout, memory_dict(), {},
                               cache=d.cache_spec)
        return m.hbm_bytes, decide([m]).fits

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    loop = ServeLoop(model, params, max_batch=POLICY_SLOTS,
                     max_len=POLICY_MAX_LEN, mesh=make_host_mesh())
    d = loop.layout_decision
    cap = d.budget_bytes * d.margin
    table = ", ".join(f"{e.key} {e.hbm_bytes / 1e9:.2f} GB" for e in d.evals)
    print(f"phase (c), ServeLoop(max_batch={POLICY_SLOTS}, max_len="
          f"{POLICY_MAX_LEN}, mesh=make_host_mesh()) at full width "
          f"({card}): decision {d.key}, cap {cap / 1e9:.2f} GB; candidates "
          f"{table}", flush=True)
    bf16 = next(e for e in d.evals if e.key == "stationary+head/bf16")
    check(d.key == "stationary+head/int8" and d.fits,
          f"policy ServeLoop at {POLICY_SLOTS} slots decided {d.key}")
    check(bf16.hbm_bytes > cap, f"head/bf16 at {bf16.hbm_bytes / 1e9:.2f} "
          f"GB is not over the {cap / 1e9:.2f} GB cap")
    alloc = tree_bytes(loop.cache)
    check(alloc == d.chosen.detail["cache_bytes"], f"allocated cache "
          f"{alloc} B != predicted {d.chosen.detail['cache_bytes']} B")
    per = {"prefill": [], "decode": []}
    for attr, path in (("_prefill", "prefill"), ("_decode", "decode")):
        def counted(*args, inner=getattr(loop, attr), path=path):
            before = counts()
            out = inner(*args)
            per[path].append({k: v - before[k] for k, v in counts().items()})
            return out
        setattr(loop, attr, counted)
    flash.launches = 0
    flash.routes.update(dict.fromkeys(flash.routes, 0))
    q8.quantize_grouped_cuda.launches = 0
    q8.dequantize_grouped_cuda.launches = 0
    with held_quant8(torch) as held:
        done = drain(loop, [Request(rid=i, prompt=p, max_new=POLICY_NEW)
                            for i, p in enumerate(prompts)])
    launches = counts()
    wall = time.perf_counter() - t0
    check(sorted(done) == list(range(len(prompts)))
          and all(len(o) == POLICY_NEW for o in done.values()),
          f"policy ServeLoop: {len(done)} requests done")
    steps = len(per["decode"])
    pre_want = {"flash_attention": L, "quantize": L, "dequantize": 0}
    dec_want = {"flash_attention": 0, "quantize": L, "dequantize": L}
    check(len(per["prefill"]) == len(prompts)
          and all(c == pre_want for c in per["prefill"]),
          f"policy ServeLoop launches per prefill {per['prefill']}, "
          f"expected {pre_want} each")
    check(all(c == dec_want for c in per["decode"]),
          f"policy ServeLoop launches per decode step {per['decode']}, "
          f"expected {dec_want} each")
    check(launches == {k: pre_want[k] * len(prompts) + dec_want[k] * steps
                       for k in launches}, f"launches {launches}")
    check(flash.routes["wgmma"] == launches["flash_attention"],
          f"policy ServeLoop flash routes {flash.routes}")
    errs = {}
    for name, calls in held.items():
        n_want = 2 * launches[name]           # K and V: two leaves a call
        check(len(calls) == n_want, f"policy ServeLoop: {len(calls)} "
              f"{name} leaves held, expected {n_want}")
        errs[name] = float(torch.stack([e for _, e in calls]).max())
        check(errs[name] == 0.0, f"policy ServeLoop quant8 {name} vs plain "
              f"max |diff| {errs[name]}")
    prefill = make_prefill_step(loop.model)
    first = []
    for i, p in enumerate(prompts):
        nxt, pc = prefill(params, {"tokens": torch.as_tensor(
            p[None], device="cuda")})
        first.append(int(nxt[0]) == done[i][0])
        del pc
    check(all(first), f"policy ServeLoop first tokens vs solo {first}")
    print(f"phase (c): {len(prompts)} requests (prompts {POLICY_LENGTHS}) x "
          f"{POLICY_NEW} tokens in {wall:.2f} s, {steps} decode steps; "
          f"launches {launches}: per admitted prefill {pre_want}, per decode "
          f"step {dec_want}; every quant8 call bit-equal to the plain "
          f"version ({len(held['quantize'])} quantised and "
          f"{len(held['dequantize'])} dequantised leaves); first tokens "
          f"equal their solo prefills' ({sum(first)}/{len(prompts)}); "
          f"allocated cache {alloc / 1e9:.2f} GB = predicted", flush=True)
    # the same requests again, unchecked: the peak the policy predicted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    drain(loop, [Request(rid=10 + i, prompt=p, max_new=POLICY_NEW)
                 for i, p in enumerate(prompts)])
    peak, in_cap = measured(d)
    print(f"phase (c) at {POLICY_SLOTS} slots: peak {peak / 1e9:.2f} GB "
          f"measured beside {d.chosen.hbm_bytes / 1e9:.2f} GB predicted "
          f"({d.key}; within the {cap / 1e9:.0f} GB cap: {in_cap}; limit "
          f"{DEVICE_HBM_BYTES / 1e9:.0f} GB; {card})", flush=True)
    check(peak < DEVICE_HBM_BYTES, f"policy ServeLoop peak {peak} B")
    del loop, prefill
    torch.cuda.empty_cache()
    loop = ServeLoop(model, params, max_batch=POLICY_SMALL_SLOTS,
                     max_len=POLICY_MAX_LEN, mesh=make_host_mesh())
    d32 = loop.layout_decision
    check(d32.key == "stationary+head/bf16",
          f"policy ServeLoop at {POLICY_SMALL_SLOTS} slots decided {d32.key}")
    alloc32 = tree_bytes(loop.cache)
    check(alloc32 == d32.chosen.detail["cache_bytes"], f"allocated cache "
          f"{alloc32} B != predicted {d32.chosen.detail['cache_bytes']} B")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    drain(loop, [Request(rid=0, prompt=prompts[2], max_new=POLICY_NEW)])
    peak32, in_cap32 = measured(d32)
    print(f"phase (c) at {POLICY_SMALL_SLOTS} slots: decision {d32.key}, "
          f"peak {peak32 / 1e9:.2f} GB measured beside "
          f"{d32.chosen.hbm_bytes / 1e9:.2f} GB predicted (within the cap: "
          f"{in_cap32}), cache {alloc32 / 1e9:.2f} GB = predicted ({card})",
          flush=True)
    check(peak32 < DEVICE_HBM_BYTES, f"policy ServeLoop peak {peak32} B")
    del loop
    torch.cuda.empty_cache()
    return {"launches": launches, "per_prefill": pre_want,
            "per_decode_step": dec_want, "decode_steps": steps,
            "max_abs_err": errs, "peak_gb": peak / 1e9,
            "predicted_gb": d.chosen.hbm_bytes / 1e9,
            "bf16_gb": bf16.hbm_bytes / 1e9, "peak32_gb": peak32 / 1e9,
            "predicted32_gb": d32.chosen.hbm_bytes / 1e9}


def walk_vs_card(torch, label: str, step, card_args, meta_args, card: str,
                 runs: int = 3, kernels_on_card: dict | None = None) -> dict:
    """Phase (d): one call of `step` walked on the card and on meta
    tensors (dist/cost.py) must give the same flops by dtype, bytes and
    ops, the kernels reporting by formula on both; the roofline of the
    walk (dist/hardware.Roofline on the H100 model) must not exceed the
    step's measured time (the least of `runs` calls, synchronised).

    `kernels_on_card` ({kernel: count}) names kernels the card takes where
    meta takes the plain route (the training kernels: meta keeps the
    reference's route): the card's walk must count each that often and
    meta's none, the two walks are printed apart, and the card's walk gives
    the roofline."""
    from repro_torch.dist import cost
    from repro_torch.dist.hardware import Roofline
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    on_card = cost.analyze(step, *card_args())
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    on_meta = cost.analyze(step, *meta_args())
    t_meta = time.perf_counter() - t0
    check(on_card["out"] is not None and on_meta["out"] is not None,
          f"{label}: walk failed: card {on_card['diagnostics'][:3]}, meta "
          f"{on_meta['diagnostics'][:3]}")
    on_card["out"] = on_meta["out"] = None
    a, b = cost.totals(on_card), cost.totals(on_meta)
    if kernels_on_card:
        got = {k: (on_card["by_op"].get(k, {}).get("count", 0),
                   on_meta["by_op"].get(k, {}).get("count", 0))
               for k in kernels_on_card}
        check(got == {k: (n, 0) for k, n in kernels_on_card.items()},
              f"{label}: kernels (card, meta) {got}, expected "
              f"{kernels_on_card} on the card alone")
        print(f"phase (d), {label}: the card takes {kernels_on_card}, meta "
              f"the plain route: card flops "
              f"{ {k: f'{v:.6g}' for k, v in a['flops_by_dtype'].items()} }, "
              f"{a['hbm_bytes'] / 1e9:.3f} GB; meta flops "
              f"{ {k: f'{v:.6g}' for k, v in b['flops_by_dtype'].items()} }, "
              f"{b['hbm_bytes'] / 1e9:.3f} GB", flush=True)
        on_meta = on_card   # the roofline of what the card runs
    elif a != b:
        for k in sorted(set(a["by_op"]) | set(b["by_op"])):
            if a["by_op"].get(k) != b["by_op"].get(k):
                print(f"  {label} walk differs at {k}: card "
                      f"{a['by_op'].get(k)}, meta {b['by_op'].get(k)}")
    check(bool(kernels_on_card) or a == b, f"{label}: walk on the card != "
          f"walk on meta (flops {a['flops_by_dtype']} vs "
          f"{b['flops_by_dtype']}, bytes {a['hbm_bytes']} vs "
          f"{b['hbm_bytes']})")
    times = []
    for _ in range(runs):
        args = card_args()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(*args)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        del out, args
    measured = min(times)
    roof = Roofline.of(on_meta)
    kernels = {k: (v["count"], v["flops"], v["bytes"])
               for k, v in on_meta["by_op"].items()
               if not k.startswith("aten.")}
    top = {k: (v["count"], round(v["bytes"] / 1e9, 3)) for k, v in sorted(
        on_meta["by_op"].items(), key=lambda kv: -kv[1]["bytes"])[:8]}
    print(f"phase (d), cost walk of {label} ({card}): "
          f"{'the card' if kernels_on_card else 'card == meta'}: flops "
          f"{ {k: f'{v:.6g}' for k, v in on_meta['flops_by_dtype'].items()} }"
          f", {on_meta['hbm_bytes'] / 1e9:.3f} GB, "
          f"{sum(v['count'] for v in on_meta['by_op'].values())} ops "
          f"(kernels by formula {kernels}); walked in {t_card:.1f} s on the "
          f"card, {t_meta:.1f} s on meta; bound {roof.bound_s:.4f} s "
          f"({roof.dominant}: compute {roof.t_compute_s:.4f}, memory "
          f"{roof.t_memory_s:.4f}), measured {measured:.4f} s (least of "
          f"{[round(t, 4) for t in times]}), share of the roofline "
          f"{roof.bound_s / measured:.4f}; most bytes (count, GB): {top}",
          flush=True)
    check(roof.bound_s <= measured, f"{label}: bound {roof.bound_s} s > "
          f"measured {measured} s")
    return {"bound_s": roof.bound_s, "measured_s": measured,
            "share": roof.bound_s / measured, "dominant": roof.dominant,
            "t_compute_s": roof.t_compute_s, "t_memory_s": roof.t_memory_s,
            "flops_by_dtype": on_meta["flops_by_dtype"],
            "hbm_bytes": on_meta["hbm_bytes"], "kernels": kernels,
            "top_bytes": top,
            "times_s": times, "equal": not kernels_on_card,
            "meta": cost.totals(on_meta), "card": cost.totals(on_card)}


def prefill_walk(torch, model, params, card: str) -> dict:
    """Phase (d), granite-20b's prefill at LM_BATCH x LM_PROMPT (phase
    11's) walked on the card and on meta."""
    from repro_torch.launch import serve
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.param import abstract_params
    batch = serve.make_batch(model.cfg, np.random.default_rng(0), LM_BATCH,
                             LM_PROMPT, "cuda")
    shape = ShapeConfig("serve", "prefill", LM_PROMPT, LM_BATCH)
    return walk_vs_card(
        torch, f"{LM_ARCH} prefill {LM_BATCH}x{LM_PROMPT}",
        make_prefill_step(model), lambda: (params, batch),
        lambda: (abstract_params(model.param_defs()),
                 abstract_params(model.input_defs(shape))), card)


def train_walk(torch, card: str) -> dict:
    """Phase (d), qwen1.5-4b's train step at phase 25's shape (batch x
    seq, grad_accum 4, remat), params and adamw state drawn on the card,
    walked on the card (attention on the training kernels, by formula) and
    on meta (the plain route); its steps update the params."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import (batch_token_stream,
                                            make_token_stream)
    from repro_torch.launch import train
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.param import (abstract_params,
                                          init_params_on_device)
    from repro_torch.optim import adamw, cosine_warmup
    args = train.parse_args(TRAIN_FULL)
    model = build_model(get_config(TRAIN_ARCH))
    opt = adamw(cosine_warmup(args.lr, 10, args.steps))
    step = make_train_step(model, opt)
    params = init_params_on_device(args.seed, model.param_defs(), "cuda")
    state = opt.init(params)
    stream = make_token_stream(model.cfg.vocab_size, 400_000, seed=args.seed)
    x, y = batch_token_stream(stream, args.batch, args.seq, 0)
    batch = {"tokens": torch.as_tensor(x, device="cuda"),
             "labels": torch.as_tensor(y, device="cuda")}
    shape = ShapeConfig("train", "train", args.seq, args.batch)

    def meta():
        p = abstract_params(model.param_defs())
        return p, opt.init(p), abstract_params(model.input_defs(shape))
    per = train_attention_launches(model.cfg, 1)
    rec = walk_vs_card(
        torch, f"{TRAIN_ARCH} train step {args.batch}x{args.seq} "
        f"(grad_accum {model.cfg.grad_accum}, remat {model.cfg.remat})",
        step, lambda: (params, state, batch), meta, card, runs=2,
        kernels_on_card={"flash_attention_train_fwd": per["train_fwd"],
                         "flash_attention_train_bwd": per["train_bwd"]})
    del params, state
    torch.cuda.empty_cache()
    return rec


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 1
    from repro_torch.core.hierarchy import FogTopology
    from repro_torch.examples import fl_exchange, quickstart
    from repro_torch.examples.logits_gap import DEPTH_CUT
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
                                     "flash_attention_train (D 64)",
                                     "flash_attention_train (D 128)",
                                     "linrec"),
                             (kernel.library, q8.library, fa.library,
                              lambda: fa.train_library(64),
                              lambda: fa.train_library(128), lrk.library)):
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

    # 7. the scenario engine on the card, counted from zero
    scenario_launches = scenarios_path(torch, card)

    # 8. quant8 kernels vs plain version (launches here are not the path's)
    q8_rows = quant8_sweep(torch)
    quant8_mixed_lists(torch)
    q8_main = quant8_exchange_shapes(torch)

    # 9. the exchange path, counted from zero: the entry point at P = 2,
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

    # 10. flash_attention vs plain version (launches here are not the path's)
    fa_recs = flash_sweep(torch)
    fa_main = fa_recs[LM_ARCH]
    # 10b. the training kernels against attention_full's autograd, timed
    fa_train = flash_train_sweep(torch)

    # (a) the hardware model against the card
    hw_rec = hardware_check(torch, card)

    # 11. the LM serving path at full width, counted from zero; (b) its
    #     layout decision against the drawn params and allocated cache
    res, lm_launches, lm_peak = lm_serve(torch, LM_ARCH, LM_BATCH)
    decision_rec = decision_check(torch, res, card)
    model, params = res["model"], res["params"]
    del res
    lm_kernel_vs_plain(torch, model, params)

    # 12. continuous batching at full width, counted from zero
    loop_launches = lm_serve_loop(torch, model, params, LOOP_LENGTHS)
    # (c) the ServeLoop the policy sizes (head/int8 at 48 slots), counted
    #     from zero; (d) the cost walk of the prefill, card against meta
    policy = policy_loop(torch, model, params, card)
    walks = {f"{LM_ARCH} prefill": prefill_walk(torch, model, params, card)}
    del model, params
    torch.cuda.empty_cache()

    # 13. paged serving through serve.py --paged at full width, counted
    #     from zero; 14. paged against contiguous on the parity trace;
    #     15. contiguous chunked prefill into an int8 cache, quant8
    #     counted from zero
    t0 = time.perf_counter()
    res, paged_launches = paged_serve(torch, card)
    model, params = res["model"], res["params"]
    del res
    paged_vs_contiguous(torch, model, params, card)
    chunk_res = chunked_int8(torch, model, params, card)
    chunk_q8 = chunk_res["launches"]
    print(f"paged and chunked phases: {time.perf_counter() - t0:.1f} s "
          f"({card})", flush=True)
    del model, params
    torch.cuda.empty_cache()

    # 16. linrec vs plain version (launches here are not the path's)
    lr_main = linrec_sweep(torch)

    # 17. falcon-mamba-7b at full width, counted from zero
    res, ssm_launches, ssm_peak = lm_serve(torch, SSM_ARCH, SSM_BATCH)
    model, params = res["model"], res["params"]
    del res
    lm_kernel_vs_plain(torch, model, params)

    # 18. falcon-mamba-7b in the ServeLoop, counted from zero
    ssm_loop_launches = lm_serve_loop(torch, model, params, SSM_LOOP_LENGTHS)
    del model, params
    torch.cuda.empty_cache()

    # 19. recurrentgemma-9b at full width, counted from zero
    res, hybrid_launches, hybrid_peak = lm_serve(torch, HYBRID_ARCH,
                                                 HYBRID_BATCH)
    model, params = res["model"], res["params"]
    del res
    lm_kernel_vs_plain(torch, model, params)
    del model, params
    torch.cuda.empty_cache()

    # 20-21. the MoE archs at full width, DEPTH_CUT layers, counted from
    #        zero: serve, kernels vs plain with the routing check, the
    #        ServeLoop
    moe = {}
    for arch in MOE_ARCHS:
        t0 = time.perf_counter()
        res, serve_launches, peak = lm_serve(torch, arch, MOE_BATCH,
                                             layers=DEPTH_CUT[arch])
        model, params = res["model"], res["params"]
        steps = res["decode_steps"]
        moe[arch] = {"serve": serve_launches, "peak_gb": peak,
                     "prefill_ms": res["prefill_s"] * 1e3,
                     "decode_ms": res["decode_s"] * 1e3 / steps}
        del res
        moe[arch].update(lm_kernel_vs_plain(torch, model, params))
        moe[arch]["loop"] = lm_serve_loop(torch, model, params,
                                          MOE_LOOP_LENGTHS)
        moe[arch]["layer_ms"] = moe_layer_times(torch, model, params, card)
        moe[arch]["wall_s"] = time.perf_counter() - t0
        print(f"{arch} full width, {DEPTH_CUT[arch]} layers, phase: prefill "
              f"{MOE_BATCH}x{LM_PROMPT} {moe[arch]['prefill_ms']:.1f} ms, "
              f"decode {moe[arch]['decode_ms']:.2f} ms/step, peak "
              f"{peak:.2f} GB, {moe[arch]['wall_s']:.1f} s wall ({card})",
              flush=True)
        del model, params
        torch.cuda.empty_cache()

    # 22-23. phi-3-vision-4.2b (the VLM stub) and seamless-m4t-large-v2
    #        (the enc-dec) at full width, counted from zero: serve,
    #        kernels vs plain, the ServeLoop (refused for the enc-dec)
    fam = {arch: family_serve(torch, arch, card)
           for arch in (VLM_ARCH, AUDIO_ARCH)}

    # 24. every smoke arch's train step, card vs CPU, counted from zero;
    # 25. qwen1.5-4b trained at full width, whole, counted from zero;
    # 26. its federated loop cut to 4 layers, quant8 counted from zero
    tr_smoke = train_smoke(torch)
    tr_full = train_full(torch, card)
    # (d) the cost walk of the full-width train step, card against meta
    walks[f"{TRAIN_ARCH} train step"] = train_walk(torch, card)
    tr_fl = train_fl(torch, card)
    out = ROOT / "artifacts" / "cost_walk_card.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(walks, indent=1, default=str))

    # 27. results
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
        "launches": launches + paper_launches["figures"] + resume_launches
        + scenario_launches,
        "launches_by_path": {"quickstart": launches,
                             "paper_suite": paper_launches["figures"],
                             "resume": resume_launches,
                             "scenarios": scenario_launches},
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
            # the exchange path's, the chunked int8 prefill's, the train
            # loop's exchanges and the policy's int8 ServeLoop
            "launches": q8_launches[name] + chunk_q8[name]
            + tr_fl["quant8"][name] + policy["launches"][name],
            "launches_by_path": {"exchange": q8_launches[name],
                                 "chunked_int8_prefill": chunk_q8[name],
                                 "train_exchange": tr_fl["quant8"][name],
                                 "policy_int8_serveloop":
                                     policy["launches"][name]},
            # the exchange's group and every call of the chunked prefill
            # and of the policy's ServeLoop
            "max_abs_err": max(t["max_abs_err"],
                               chunk_res["max_abs_err"][name],
                               policy["max_abs_err"][name]),
            **({"overhead_launches":
                paper_launches["overhead"]["quant8_quantize"]}
               if name == "quantize" else {}),
            "ms": t["grouped_cold_ms"], "plain_ms": t["plain_cold_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_cold_ms"],
            "warm_ms": t["grouped_ms"], "plain_warm_ms": t["plain_ms"],
            "library_warm_ms": t["library_ms"]})
    flash_paths = {f"{LM_ARCH} serve": lm_launches["flash_attention"],
                   f"{LM_ARCH} ServeLoop": loop_launches["flash_attention"],
                   f"{LM_ARCH} policy ServeLoop (head/int8)":
                       policy["launches"]["flash_attention"],
                   f"{HYBRID_ARCH} serve":
                       hybrid_launches["flash_attention"]}
    for arch, r in (*moe.items(), *fam.items()):
        flash_paths[f"{arch} serve"] = r["serve"]["flash_attention"]
        if "loop" in r:
            flash_paths[f"{arch} ServeLoop"] = r["loop"]["flash_attention"]
    # training reaches no prefill flash launch in phases 24-26; its
    # attention runs on the training kernels (their own entry below)
    train_paths = {"train smoke steps": tr_smoke["launches"],
                   f"{TRAIN_ARCH} train": tr_full["launches"],
                   f"{TRAIN_ARCH} train loop": {
                       k: sum(c["quant8"][k] for c in tr_fl["cases"].values())
                       for k in ("flash_attention", "linrec", "train_fwd",
                                 "train_bwd")}}
    for path, n in train_paths.items():
        flash_paths[path] = n["flash_attention"]
    table.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:105",
        "launches": sum(flash_paths.values()),
        "launches_by_path": flash_paths,
        "max_abs_err": fa_main["max_abs_err"], "ms": fa_main["ms"],
        "plain_ms": fa_main["plain_ms"], "bound_ms": fa_main["bound_ms"],
        "bound_by": fa_main["bound_by"],
        "library_ms": fa_main["library_ms"],
        # the other full-width prefill shapes, timed in the same call
        "other_shapes": {arch: r for arch, r in fa_recs.items()
                         if arch != LM_ARCH}})
    # the training kernels (no TPU kernel: the reference differentiates
    # its plain attention); ms is the backward at the benchmark cell's
    # shape, fwd_ms the forward with its lse
    table.append({
        "name": "flash_attention_train", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention_train.cu",
        "replaces": None,
        "launches": sum(n["train_fwd"] + n["train_bwd"]
                        for n in train_paths.values()),
        "launches_by_path": {path: {k: n[k] for k in ("train_fwd",
                                                      "train_bwd")}
                             for path, n in train_paths.items()},
        "max_rel_err": max(max(r["vs_attention_full"])
                           for r in fa_train["shapes"].values()),
        **{k: fa_train[k] for k in ("ms", "fwd_ms", "prefill_ms", "bound_ms",
                                    "bound_by", "fwd_bound_ms", "plain_ms",
                                    "library_ms")}})
    # linrec on its main path: the tma route at falcon's prefill scan; the
    # column kernel (the other route) read in the same call
    lr = lr_main[f"{SSM_ARCH} prefill"]
    table.append({
        "name": "linrec", "route": "cuda",
        "source": "src/repro_torch/kernels/linrec/csrc/linrec.cu",
        "replaces": "src/repro/kernels/linrec/kernel.py:66",
        "launches": sum(r["linrec"] for r in (
            ssm_launches, ssm_loop_launches, hybrid_launches)),
        "launches_by_path": {
            f"{SSM_ARCH} serve": ssm_launches["linrec"],
            f"{SSM_ARCH} ServeLoop": ssm_loop_launches["linrec"],
            f"{HYBRID_ARCH} serve": hybrid_launches["linrec"],
            **{path: n["linrec"] for path, n in train_paths.items()}},
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
          f"{loop_launches}, paged serve {paged_launches}, chunked int8 "
          f"prefill quant8 {chunk_q8}; {SSM_ARCH} serve {ssm_launches}, "
          f"ServeLoop {ssm_loop_launches}; {HYBRID_ARCH} serve "
          f"{hybrid_launches}. "
          f"Serve peak memory: {LM_ARCH} {lm_peak:.2f} GB, {SSM_ARCH} "
          f"{ssm_peak:.2f} GB, {HYBRID_ARCH} {hybrid_peak:.2f} GB, "
          + ", ".join([f"{arch} ({DEPTH_CUT[arch]} layers) "
                       f"{r['peak_gb']:.2f} GB" for arch, r in moe.items()]
                      + [f"{arch} {r['peak_gb']:.2f} GB"
                         for arch, r in fam.items()]), flush=True)
    best = min(tr_full["steps"], key=lambda r: r["ms"])
    print(f"training: {TRAIN_ARCH} full width, whole, best step "
          f"{best['ms']:.1f} ms, {best['tokens_per_s']:,.0f} tokens/s, "
          f"{best['peak_share']:.4f} of the dense bf16 peak, peak memory "
          f"{tr_full['peak_gb']:.2f} GB; its loop cut to {TRAIN_FL_LAYERS} "
          f"layers x 2 islands, peak "
          + ", ".join(f"{k} {c['peak_gb']:.2f} GB"
                      for k, c in tr_fl["cases"].items())
          + f"; quant8 in the train loop {tr_fl['quant8']} ({card})",
          flush=True)
    print(f"planning layer ({card}): bf16 matmul "
          f"{hw_rec['matmul_flops_per_s'] / 1e12:.1f} TFLOP/s, copy "
          f"{hw_rec['copy_bytes_per_s'] / 1e12:.3f} TB/s; serve.py "
          f"{decision_rec['key']} (predicted {decision_rec['predicted_gb']:.2f}"
          f" GB, measured {decision_rec['measured_gb']:.2f} GB); policy "
          f"ServeLoop head/int8 peak {policy['peak_gb']:.2f} GB (predicted "
          f"{policy['predicted_gb']:.2f}), head/bf16 at {POLICY_SMALL_SLOTS} "
          f"slots {policy['peak32_gb']:.2f} GB (predicted "
          f"{policy['predicted32_gb']:.2f}); walks "
          + ", ".join(f"{k}: bound {w['bound_s']:.4f} s / measured "
                      f"{w['measured_s']:.4f} s = {w['share']:.4f} "
                      f"({w['dominant']})" for k, w in walks.items()),
          flush=True)
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

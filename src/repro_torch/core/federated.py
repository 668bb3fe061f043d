"""Tier B: the paper's FL technique as an island exchange, port of
`repro.core.federated`.

Each island is one federated silo.  Islands run E local steps, then
exchange weights through ONE mixing contraction:

    new_params_i = sum_j M[i, j] * params_j        (M: island mixing matrix)

M encodes the whole FLight control plane -- worker selection (zeroed
columns), FedAvg weighting (data-proportional rows), and async staleness
mixes (diagonal + rank-1) -- as runtime inputs.  On one card the P islands
are the leading tensor axis of every leaf and the exchange is a local
contraction with the reference's math (the reference shards that axis over
a `pod` mesh axis and makes it a collective).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import spans
from repro_torch.core import aggregation, compression
from repro_torch.core.client import draw_orders
from repro_torch.kernels.quant8 import ops as q8ops
from repro_torch.tree import leaves, tree_map, unflatten_like


@dataclasses.dataclass(frozen=True)
class FLConfig:
    n_islands: int = 1
    local_steps: int = 8           # E: train steps between aggregations
    aggregation: str = "fedavg"
    mode: str = "sync"             # sync | async
    async_base_alpha: float = 0.6
    staleness_scheme: str = "polynomial"
    compress: str = "none"         # exchange compression:
    #                                none | q8 | topk | q8_topk
    topk_frac: float = 0.05        # kept fraction for the topk modes
    overlap: bool = False          # double-buffer exchange w/ local steps


def stack_islands(tree, n_islands: int):
    """Tile a single-island tree into (n_islands, ...) leaves."""
    return tree_map(lambda x: x.unsqueeze(0).expand(n_islands, *x.shape)
                    .contiguous(), tree)


def island_slice(tree, i: int):
    return tree_map(lambda x: x[i], tree)


def cohort_train(trainer, params, shards, keys, epochs: int):
    """Train a whole cohort in ONE batched step: stack the worker shards
    along a leading cohort axis and run the trainer's vmapped step over it
    (`params` broadcast, the `stack_islands` layout).  Each Threefry key
    becomes its member's batch orders (`client.draw_orders`), the orders
    the reference's trainer draws from it.  Returns params stacked
    (C, ...) -- feed straight into `fl_aggregate` /
    `hierarchy.hierarchical_sync_aggregate`.

    shards: sequence of (images, labels) with EQUAL shapes."""
    device = leaves(params)[0].device
    images = torch.stack([torch.as_tensor(x) for x, _ in shards]).to(device)
    labels = torch.stack([torch.as_tensor(y) for _, y in shards]).to(device)
    n = int(images.shape[1])
    orders = torch.stack([draw_orders(k, n, int(epochs)) for k in keys])
    return trainer.train_cohort(params, images, labels, orders, epochs)


def fl_aggregate(stacked_params, mixing):
    """The FLight exchange: one mixing contraction over the island axis.
    stacked_params: tree with a leading island axis; mixing: (P, P)
    (selection/weights/staleness encoded)."""
    return aggregation.mix_islands(stacked_params, mixing)


def fl_aggregate_compressed(stacked_params, base_params, mixing, *,
                            mode: str = "q8", k_frac: float = 0.05,
                            impl: str = "auto"):
    """Exchange compressed DELTAS from the shared last-sync base instead of
    raw weights: (sparsify ->) quantise -> dequantise -> mixing contraction.

    Every island already holds `base_params` (the previous exchange's
    result), so only the compressed delta crosses the wire: int8 + one
    fp32 scale per last-dim row for "q8" (~4x fewer bytes than f32),
    optionally top-k sparsified first ("topk" keeps fp32 values, "q8_topk"
    stacks both).  Requires row-stochastic mixing (sum_j M[i,j] = 1), which
    all FLight mixes satisfy.  The top-k stage is the threshold-mask form
    (compression.topk_mask), per island.

    Quantise and dequantise run through kernels/quant8, each as ONE
    grouped call over all leaves (the reference computes the whole tree in
    one jitted step): on the card one launch each per exchange hop, on the
    CPU or with impl="ref" their plain version.  Its spans
    (`repro_torch.spans`), one each a hop: `exchange.delta` (casts,
    subtract, top-k mask), `exchange.quantise`, `exchange.dequantise`,
    `exchange.mix` (contraction, add, cast, unflatten)."""
    if mode == "none":
        return fl_aggregate(stacked_params, mixing)
    if mode not in compression.MODES:
        raise ValueError(f"unknown exchange compression mode '{mode}'")
    xs, bs = leaves(stacked_params), leaves(base_params)
    with spans.span("exchange.delta"):
        deltas = [x.float() - b.float() for x, b in zip(xs, bs)]
        if mode in ("topk", "q8_topk"):
            # per-island top-k over the leaf (batch dim = island axis)
            deltas = [torch.where(compression.topk_mask(
                d, k_frac=k_frac, batch_dims=1), d, 0.0) for d in deltas]
    if mode in ("q8", "q8_topk"):
        with spans.span("exchange.quantise"):
            qs, ss = zip(*q8ops.quantize_rowwise_grouped(deltas, impl=impl))
        with spans.span("exchange.dequantise"):
            deltas = q8ops.dequantize_rowwise_grouped(qs, ss, impl=impl)
    with spans.span("exchange.mix"):
        m = torch.as_tensor(mixing, device=xs[0].device).float()
        return unflatten_like(stacked_params, [
            (b.float() + torch.tensordot(m, d, dims=1)).to(x.dtype)
            for x, b, d in zip(xs, bs, deltas)])


def fl_aggregate_robust(stacked_params, method: str, *, base_params=None,
                        **kw):
    """Byzantine-robust exchange: every island receives the robust fold of
    all island models (trimmed mean / median / multi-Krum / norm clipping,
    see aggregation.ROBUST_METHODS) instead of the mixing-matrix weighted
    average.  Not expressible as a row-stochastic mixing matrix --
    robustness is exactly the refusal to take fixed linear combinations an
    attacker could dominate."""
    agg = aggregation.robust_aggregate_stacked(stacked_params, method,
                                               base=base_params, **kw)
    return tree_map(lambda a, s: a.to(s.dtype)[None].expand(s.shape)
                    .contiguous(), agg, stacked_params)


def fl_overlap_merge(params, mixed, snapshot):
    """Re-apply the local progress made WHILE the exchange was in flight:
    with a double-buffered exchange the first local step of round r+1
    starts from the pre-exchange snapshot, and when the exchange lands its
    correction (mixed - snapshot) is added on top of the current params --
    the exchange is one step stale, the local step is never recomputed."""
    return tree_map(lambda p, m, s: (p.float() + m.float()
                                     - s.float()).to(p.dtype),
                    params, mixed, snapshot)


def selection_mixing(weights: np.ndarray, selected: np.ndarray) -> np.ndarray:
    """Sync FedAvg restricted to selected islands; unselected islands still
    RECEIVE the aggregate (they re-sync, matching the paper's workers that
    download the latest server model when next contacted)."""
    w = np.asarray(weights, np.float64) * np.asarray(selected, np.float64)
    if w.sum() <= 0:
        return np.eye(len(w))
    w = w / w.sum()
    return aggregation.sync_mixing_matrix(w)


def async_mixing(alphas, contributors) -> np.ndarray:
    return aggregation.async_mixing_matrix(np.asarray(alphas),
                                           np.asarray(contributors))


@dataclasses.dataclass
class IslandClock:
    """Host-side straggler monitor: EWMA step-times per island (the Tier-B
    analogue of the FogBus2 profiler feeding Algorithm 2)."""
    n_islands: int
    beta: float = 0.3
    ewma: Optional[np.ndarray] = None

    def observe(self, step_times: np.ndarray):
        t = np.asarray(step_times, np.float64)
        self.ewma = t if self.ewma is None else \
            (1 - self.beta) * self.ewma + self.beta * t

    def selection(self, slack: float = 1.5) -> np.ndarray:
        """Islands slower than `slack` x median are dropped this round
        (Algorithm 2's T-threshold with T = slack * median estimate)."""
        if self.ewma is None:
            return np.ones(self.n_islands)
        med = np.median(self.ewma)
        return (self.ewma <= slack * med).astype(np.float64)

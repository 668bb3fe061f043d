"""Two-tier edge -> fog -> cloud aggregation (the fog-computing topology),
port of `repro.core.hierarchy`.

FLight's setting puts an aggregation layer BETWEEN the edge workers and the
cloud server: workers report to their fog cell, each cell folds its
members with the usual weighted mean, and the cloud folds the (much fewer)
cell aggregates.  Because weighted averaging is associative over a
partition of the weights, the composition is EXACTLY the flat aggregate for
matching weights:

    cloud( fog_c( {x_j : j in c} ) )  ==  sum_j (w_j / W) x_j

for every partition {c} of the workers.  That identity makes the fog tier a
pure scaling move: each cell only touches its members, the cloud only
touches cells, and no tier materialises the full worker fan-in.

Two call surfaces:
  * dict-level (the discrete-event simulator): worker-id keyed responses
    -> `fog_aggregate_responses`, whose weighted means are the fed_agg
    kernel on the card.
  * stacked/matrix-level (the island exchange): a tree with a leading
    island axis plus mixing matrices built here, folded with
    `federated.fl_aggregate` -- the edge stage is a block-diagonal mixing
    matrix, the cloud stage a rank-structured one, and their product equals
    the flat mixing matrix.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Mapping, Sequence

import numpy as np
import torch

from repro_torch.core import aggregation, federated
from repro_torch.tree import leaves, tree_map


# --------------------------------------------------------------------------
# Topology
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FogTopology:
    """Assignment of worker ids to fog cells (cell ids are arbitrary ints)."""
    cell_of: Mapping[int, int]

    @classmethod
    def round_robin(cls, worker_ids: Iterable[int], n_cells: int
                    ) -> "FogTopology":
        ids = sorted(worker_ids)
        n_cells = max(1, int(n_cells))
        return cls({w: i % n_cells for i, w in enumerate(ids)})

    @classmethod
    def random(cls, worker_ids: Iterable[int], n_cells: int, *, seed: int = 0
               ) -> "FogTopology":
        ids = sorted(worker_ids)
        rng = np.random.default_rng(seed)
        return cls({w: int(c) for w, c in
                    zip(ids, rng.integers(0, max(1, int(n_cells)), len(ids)))})

    @property
    def n_cells(self) -> int:
        return len(set(self.cell_of.values()))

    def cells(self) -> dict[int, list[int]]:
        """cell id -> sorted member worker ids."""
        out: dict[int, list[int]] = {}
        for w in sorted(self.cell_of):
            out.setdefault(self.cell_of[w], []).append(w)
        return out

    def restrict(self, worker_ids: Iterable[int]) -> "FogTopology":
        """Topology induced on a subset (e.g. this round's selected set)."""
        keep = set(worker_ids)
        return FogTopology({w: c for w, c in self.cell_of.items()
                            if w in keep})


# --------------------------------------------------------------------------
# Dict-level: responses keyed by worker id
# --------------------------------------------------------------------------

def fog_aggregate_responses(responses: Mapping[int, object],
                            weights: Mapping[int, float],
                            topology: FogTopology, *,
                            robust: str | None = None,
                            robust_kw: Mapping | None = None,
                            impl: str = "auto"):
    """Edge->fog->cloud weighted mean of `responses`.

    Each fog cell averages its members with within-cell normalised weights;
    the cloud averages the cell aggregates weighted by each cell's weight
    MASS.  Equals the flat weighted average of all responses.  Each mean is
    one fed_agg launch on the card (`impl` selects its path).

    With `robust` set (see aggregation.ROBUST_METHODS) each fog cell folds
    its members with the robust aggregator instead -- a Byzantine worker
    can then poison at most its own cell's aggregate, and the cloud fold
    over the cell aggregates runs the SAME robust method.  Weighted
    exactness is deliberately given up: robust statistics are unweighted."""
    cells = topology.restrict(responses).cells()
    if not cells:
        raise ValueError("no responses to aggregate")
    kw = dict(robust_kw or {})
    cell_params, cell_mass = [], []
    for members in cells.values():
        w = np.array([max(float(weights[m]), 0.0) for m in members])
        mass = float(w.sum())
        wn = w / mass if mass > 0 else np.full(len(w), 1.0 / len(w))
        member_params = [responses[m] for m in members]
        if robust:
            cell_params.append(
                aggregation.robust_aggregate(member_params, robust, **kw))
        else:
            cell_params.append(
                aggregation.weighted_average(member_params, wn, impl=impl))
        cell_mass.append(mass if mass > 0 else 0.0)
    if robust and len(cell_params) > 1:
        return aggregation.robust_aggregate(cell_params, robust, **kw)
    mass = np.asarray(cell_mass)
    mn = mass / mass.sum() if mass.sum() > 0 else \
        np.full(len(mass), 1.0 / len(mass))
    return aggregation.weighted_average(cell_params, mn, impl=impl)


def hierarchical_robust_aggregate(stacked_params, cell_of: Sequence[int],
                                  method: str, *, base=None, **kw):
    """Robust edge->fog->cloud fold of a stacked (P, ...) member tree into
    ONE aggregate: each cell robust-folds its member slices, the cloud
    robust-folds the cell aggregates (same method).  The stacked sibling of
    `fog_aggregate_responses(robust=...)`."""
    cells = _cells_from_array(cell_of)
    cell_aggs = []
    for members in cells.values():
        sub = tree_map(lambda x: x[torch.as_tensor(members,
                                                   device=x.device)],
                       stacked_params)
        cell_aggs.append(aggregation.robust_aggregate_stacked(
            sub, method, base=base, **kw))
    if len(cell_aggs) == 1:
        return cell_aggs[0]
    stacked_cells = tree_map(lambda *ls: torch.stack(ls), *cell_aggs)
    return aggregation.robust_aggregate_stacked(stacked_cells, method,
                                                base=base, **kw)


# --------------------------------------------------------------------------
# Matrix-level (the island exchange): compose with fl_aggregate
# --------------------------------------------------------------------------

def _cells_from_array(cell_of: Sequence[int]) -> dict[int, np.ndarray]:
    c = np.asarray(cell_of, int)
    return {int(k): np.flatnonzero(c == k) for k in np.unique(c)}


def _norm_or_uniform(w: np.ndarray) -> np.ndarray:
    s = w.sum()
    return w / s if s > 0 else np.full(len(w), 1.0 / len(w))


def edge_mixing_matrix(weights: Sequence[float], cell_of: Sequence[int]
                       ) -> np.ndarray:
    """Fog stage: island i receives its OWN cell's weighted mean.

    Block-diagonal row-stochastic (P, P); applying it with `fl_aggregate`
    leaves every member of a cell holding that cell's aggregate."""
    w = np.maximum(np.asarray(weights, np.float64), 0.0)
    M = np.zeros((len(w), len(w)))
    for members in _cells_from_array(cell_of).values():
        M[np.ix_(members, members)] = _norm_or_uniform(w[members])[None, :]
    return M


def cloud_mixing_matrix(weights: Sequence[float], cell_of: Sequence[int]
                        ) -> np.ndarray:
    """Cloud stage AFTER the edge stage: every island receives the
    cell-mass-weighted mean of the cell aggregates.  Each cell's aggregate
    is read off its first member (rows within a cell are equal after
    `edge_mixing_matrix`)."""
    w = np.maximum(np.asarray(weights, np.float64), 0.0)
    cells = _cells_from_array(cell_of)
    mass = np.array([w[m].sum() for m in cells.values()])
    mn = _norm_or_uniform(mass)
    M = np.zeros((len(w), len(w)))
    for mi, members in zip(mn, cells.values()):
        M[:, members[0]] = mi
    return M


def flat_mixing_matrix(weights: Sequence[float]) -> np.ndarray:
    """The single-tier reference: every island gets the global mean."""
    w = np.maximum(np.asarray(weights, np.float64), 0.0)
    return aggregation.sync_mixing_matrix(_norm_or_uniform(w))


def _mixing(M: np.ndarray, stacked_params) -> torch.Tensor:
    return torch.as_tensor(M, dtype=torch.float32,
                           device=leaves(stacked_params)[0].device)


def hierarchical_sync_aggregate(stacked_params, weights: Sequence[float],
                                cell_of: Sequence[int], *,
                                compress: str = "none",
                                base_params=None,
                                k_frac: float = 0.05,
                                impl: str = "auto"):
    """Two `fl_aggregate` hops (edge then cloud) over the island axis.

    cloud_mixing_matrix @ edge_mixing_matrix == flat_mixing_matrix, so this
    equals the flat exchange -- but no single mixing has fan-in wider than
    max(cell size, n_cells).

    With compress != "none" both hops run the compressed delta exchange
    (`federated.fl_aggregate_compressed`, modes q8/topk/q8_topk, its quant8
    calls taking `impl`) against the shared last-sync `base_params`: the
    edge hop stays CELL-LOCAL, only the cell->cloud hop spans cells.  Equals
    the flat compressed exchange up to one extra quantisation of the
    fog-stage deltas (bounded by the per-row scale)."""
    edge_M = _mixing(edge_mixing_matrix(weights, cell_of), stacked_params)
    cloud_M = _mixing(cloud_mixing_matrix(weights, cell_of), stacked_params)
    if compress in (None, False, "none"):
        fog = federated.fl_aggregate(stacked_params, edge_M)
        return federated.fl_aggregate(fog, cloud_M)
    if base_params is None:
        raise ValueError("compressed hierarchical exchange needs the "
                         "shared last-sync base_params")
    fog = federated.fl_aggregate_compressed(
        stacked_params, base_params, edge_M, mode=compress, k_frac=k_frac,
        impl=impl)
    return federated.fl_aggregate_compressed(
        fog, base_params, cloud_M, mode=compress, k_frac=k_frac, impl=impl)


def hierarchical_async_aggregate(stacked_params, alphas: Sequence[float],
                                 contributors: Sequence[float],
                                 cell_of: Sequence[int]):
    """Staleness-weighted async fold through the fog tier.

    Flat reference: `fl_aggregate(x, async_mixing_matrix(a, c))`, i.e.
    island i keeps (1 - a_i) of itself plus a_i of the contributor mix.
    Here the contributor mix is built hierarchically -- cells aggregate
    their contributors, the cloud mixes cells by contribution mass -- and
    the final convex combination with each island's own params is
    elementwise."""
    c = np.maximum(np.asarray(contributors, np.float64), 0.0)
    fog = federated.fl_aggregate(
        stacked_params, _mixing(edge_mixing_matrix(c, cell_of), stacked_params))
    mix = federated.fl_aggregate(
        fog, _mixing(cloud_mixing_matrix(c, cell_of), stacked_params))
    a = np.asarray(alphas, np.float64)

    def combine(x, m):
        av = torch.as_tensor(a, dtype=torch.float32, device=x.device)
        av = av.reshape((-1,) + (1,) * (x.dim() - 1))
        return ((1.0 - av) * x.float() + av * m.float()).to(x.dtype)

    return tree_map(combine, stacked_params, mix)

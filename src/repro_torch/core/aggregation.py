"""Aggregation algorithms (paper SSII-A / SSIII-C.4), port of
`repro.core.aggregation`.

All operate on parameter trees (dicts of tensors).  The paper's four
families:
  * federated averaging          -- weights proportional to worker data size
  * linear weighted averaging    -- staleness-discounted, linear decay
  * polynomial weighted          -- (staleness+1)^-a decay
  * exponential weighted         -- exp(-lam*staleness) decay
plus the asynchronous single-worker merge.  Both merges run through the
fed_agg kernel (kernels/fed_agg) on CUDA: one launch per aggregation.

Averaging is computed in fp32 regardless of the storage dtype.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.kernels.fed_agg.ops import fed_agg_tree
from repro_torch.tree import leaves, tree_map


# --------------------------------------------------------------------------
# Weighting schemes
# --------------------------------------------------------------------------

def aggregation_weights(
    scheme: str,
    n_data: Sequence[float],
    staleness: Sequence[float] | None = None,
    *,
    poly_a: float = 1.0,
    exp_lam: float = 0.5,
    lin_lam: float = 0.25,
) -> np.ndarray:
    """Normalised per-worker weights for one aggregation round."""
    n = np.asarray(n_data, np.float64)
    s = np.zeros_like(n) if staleness is None else np.asarray(staleness,
                                                              np.float64)
    if scheme == "uniform":
        w = np.ones_like(n)
    elif scheme == "fedavg":
        w = n
    elif scheme == "linear":
        w = n * np.maximum(0.0, 1.0 - lin_lam * s)
    elif scheme == "polynomial":
        w = n * np.power(1.0 + s, -poly_a)
    elif scheme == "exponential":
        w = n * np.exp(-exp_lam * s)
    else:
        raise ValueError(f"unknown aggregation scheme '{scheme}'")
    tot = w.sum()
    if tot <= 0:  # every candidate fully discounted -> fall back to uniform
        w = np.ones_like(n)
        tot = w.sum()
    return (w / tot).astype(np.float64)


# --------------------------------------------------------------------------
# Tree merges (fed_agg kernel on CUDA)
# --------------------------------------------------------------------------

def weighted_average(param_list, weights, *, impl: str = "auto"):
    """sum_i w_i * params_i, computed in fp32, cast back to leaf dtype."""
    w = np.asarray(weights, np.float64)
    if len(param_list) != len(w) or abs(float(w.sum()) - 1.0) >= 1e-6:
        raise ValueError(f"weighted_average: {len(param_list)} trees, "
                         f"{len(w)} weights summing to {w.sum()}")
    return fed_agg_tree(param_list, w, impl=impl)


def async_merge(server_params, worker_params, alpha: float, *,
                impl: str = "auto"):
    """M_s <- (1-a) M_s + a M_w  (asynchronous single-response fold): the
    K=2 case of the weighted merge."""
    a = float(alpha)
    return fed_agg_tree([server_params, worker_params],
                        np.array([1.0 - a, a]), impl=impl)


def staleness_alpha(base_alpha: float, staleness: float, *,
                    scheme: str = "polynomial", poly_a: float = 0.5,
                    exp_lam: float = 0.3) -> float:
    """Mixing rate for async merges, decayed by version lag (FedAsync-style;
    the paper's 'biased to newer versions of the aggregation server model')."""
    s = max(0.0, float(staleness))
    if scheme == "constant":
        d = 1.0
    elif scheme == "polynomial":
        d = (1.0 + s) ** (-poly_a)
    elif scheme == "exponential":
        d = float(np.exp(-exp_lam * s))
    else:
        raise ValueError(scheme)
    return float(base_alpha) * d


# --------------------------------------------------------------------------
# Sanitization helpers (the server-side gate; see server.AggregationServer)
# --------------------------------------------------------------------------

def tree_finite(tree) -> bool:
    """True iff every entry of every leaf is finite (no NaN/Inf)."""
    return bool(torch.stack([torch.isfinite(l.float()).all()
                             for l in leaves(tree)]).all())


def delta_norm(tree, base) -> float:
    """Global L2 norm of (tree - base) across all leaves: per-leaf sums of
    squares in fp32, added in fp64 (one host sync)."""
    sums = [((t.float() - b.float()) ** 2).sum()
            for t, b in zip(leaves(tree), leaves(base))]
    return float(np.sqrt(float(torch.stack(sums).double().sum())))


# --------------------------------------------------------------------------
# Byzantine-robust aggregators (defense half of core/faults.py)
# --------------------------------------------------------------------------

ROBUST_METHODS = ("trimmed_mean", "median", "krum", "norm_clip")


def _stack_trees(param_list):
    return tree_map(lambda *ls: torch.stack([l.float() for l in ls]),
                    *param_list)


def _flatten_members(stacked) -> torch.Tensor:
    """(P, D) matrix: each member's leaves flattened and concatenated."""
    ls = leaves(stacked)
    P = ls[0].shape[0]
    return torch.cat([l.float().reshape(P, -1) for l in ls], dim=1)


def trim_k(n_members: int, trim_frac: float) -> int:
    """Entries trimmed per SIDE: ceil(frac * P), clamped so at least one
    member survives.  ceil means frac matching the Byzantine fraction
    always trims at least that many."""
    k = int(np.ceil(max(float(trim_frac), 0.0) * n_members))
    return min(k, (n_members - 1) // 2)


def krum_select(stacked, f: int, m: int | None = None) -> np.ndarray:
    """Multi-Krum selection (Blanchard et al. 2017): score each member by
    the sum of its P - f - 2 smallest squared distances to the others,
    return the indices of the m lowest-scoring members (m = P - f by
    default).  f is clamped into f < (P - 2) / 2."""
    X = _flatten_members(stacked)
    P = X.shape[0]
    f = max(0, min(int(f), (P - 3) // 2)) if P >= 3 else 0
    m = P - f if m is None else max(1, min(int(m), P))
    if P <= 2:
        return np.arange(P)
    sq = (X * X).sum(dim=1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (X @ X.T)
    eye = torch.eye(P, dtype=torch.bool, device=X.device)
    d2 = torch.where(eye, torch.inf, d2.clamp_min(0.0))
    n_near = max(1, P - f - 2)
    scores = torch.sort(d2, dim=1).values[:, :n_near].sum(dim=1)
    order = torch.argsort(scores, stable=True).cpu().numpy()
    return np.sort(order[:m])


def _median0(x: torch.Tensor) -> torch.Tensor:
    """Median over axis 0, averaging the two middle entries for even P
    (numpy's / jnp.median's convention; torch.median takes the lower)."""
    s = torch.sort(x, dim=0).values
    P = s.shape[0]
    if P % 2:
        return s[P // 2]
    return (s[P // 2 - 1] + s[P // 2]) * 0.5


def robust_aggregate_stacked(stacked, method: str, *, trim_frac: float = 0.2,
                             krum_f: int | None = None,
                             krum_m: int | None = None,
                             base=None, clip_mult: float = 2.0,
                             weights=None):
    """Robust fold of a stacked (P, ...) member tree into ONE aggregate.

    trimmed_mean / median / krum are deliberately UNWEIGHTED: data-size
    weighting would let an attacker buy influence by advertising samples.
    norm_clip keeps the weighted mean but first clips every member's
    delta-from-`base` to clip_mult x the median delta norm (needs `base`).
    """
    P = leaves(stacked)[0].shape[0]
    if method == "trimmed_mean":
        k = trim_k(P, trim_frac)

        def tm(leaf):
            x = torch.sort(leaf.float(), dim=0).values
            x = x[k: P - k] if k > 0 else x
            return x.mean(dim=0).to(leaf.dtype)
        return tree_map(tm, stacked)

    if method == "median":
        return tree_map(lambda l: _median0(l.float()).to(l.dtype), stacked)

    if method == "krum":
        f = int(np.ceil(0.2 * P)) if krum_f is None else int(krum_f)
        sel = krum_select(stacked, f, krum_m)

        def km(leaf):
            idx = torch.as_tensor(sel, device=leaf.device)
            return leaf.float()[idx].mean(dim=0).to(leaf.dtype)
        return tree_map(km, stacked)

    if method == "norm_clip":
        if base is None:
            raise ValueError("norm_clip needs the dispatch base")
        X = _flatten_members(stacked)
        b = _flatten_members(tree_map(lambda x: x[None], base)).reshape(-1)
        norms = torch.linalg.vector_norm(X - b[None, :], dim=1)
        thr = clip_mult * _median0(norms)
        scale = torch.minimum(torch.ones_like(norms),
                              thr / norms.clamp_min(1e-12))
        w = np.full(P, 1.0 / P) if weights is None else \
            np.asarray(weights, np.float64) / max(np.sum(weights), 1e-12)
        wt = torch.as_tensor(w, dtype=torch.float32).to(X.device)

        def nc(leaf, bleaf):
            l32 = leaf.float()
            b32 = bleaf.float()
            shape = (P,) + (1,) * (l32.dim() - 1)
            clipped = b32[None] + scale.reshape(shape) * (l32 - b32[None])
            return (wt.reshape(shape) * clipped).sum(dim=0).to(leaf.dtype)
        return tree_map(nc, stacked, base)

    raise ValueError(f"unknown robust method '{method}' "
                     f"(have {ROBUST_METHODS})")


def robust_aggregate(param_list, method: str, **kw):
    """List-of-trees front-end for `robust_aggregate_stacked` (the
    discrete-event server's responses)."""
    if not param_list:
        raise ValueError("no updates to aggregate")
    out = robust_aggregate_stacked(_stack_trees(param_list), method, **kw)
    return tree_map(lambda o, t: o.to(t.dtype), out, param_list[0])


# --------------------------------------------------------------------------
# Mixing-matrix form (the island exchange)
# --------------------------------------------------------------------------

def sync_mixing_matrix(weights: np.ndarray) -> np.ndarray:
    """Every island receives the same weighted average: M = 1 w^T."""
    w = np.asarray(weights, np.float64)
    P = w.shape[0]
    return np.tile(w[None, :], (P, 1))


def async_mixing_matrix(alphas: np.ndarray, contributors: np.ndarray
                        ) -> np.ndarray:
    """Island i keeps (1-a_i) of itself and takes a_i of the contributor mix.

    alphas: (P,) per-island mixing rates (0 => island unchanged this round);
    contributors: (P,) nonnegative contribution weights (who is 'fresh').
    """
    a = np.asarray(alphas, np.float64)
    c = np.asarray(contributors, np.float64)
    c = c / max(c.sum(), 1e-12)
    M = np.diag(1.0 - a) + np.outer(a, c)
    if not np.allclose(M.sum(axis=1), 1.0):
        raise ValueError("mixing rows must sum to 1 (alphas in [0, 1])")
    return M


def mix_islands(stacked_params, mixing):
    """new_i = sum_j M[i,j] params_j over the leading island axis: the
    island exchange as one local contraction on the card.

    fp32 leaves are a (P, P) x (P, N) product (`torch.tensordot`, full fp32:
    runtime.py leaves TF32 off).  bf16 leaves follow the reference's branch:
    the weights are rounded to bf16 and the islands summed elementwise in
    bf16."""

    def mix(leaf):
        m = torch.as_tensor(mixing, device=leaf.device).float()
        if leaf.dtype == torch.bfloat16:
            P = leaf.shape[0]
            w = m.to(torch.bfloat16).reshape((P, P) + (1,) * (leaf.dim() - 1))
            return (w * leaf[None]).sum(dim=1)
        out = torch.tensordot(m, leaf.float(), dims=1)
        return out.to(leaf.dtype)

    return tree_map(mix, stacked_params)

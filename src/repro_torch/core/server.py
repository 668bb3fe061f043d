"""Aggregation server (paper SSIII-C), port of `repro.core.server`: model
versioning, worker selection, sync barrier / async merges, and the
accuracy-driven policy updates.

Beyond-paper robustness, as in the reference:

  * SANITIZATION GATE -- every response passes two checks before it can
    touch the server model: a non-finite scan (any NaN/Inf rejects the
    update outright) and a norm-outlier test (delta norm vs the median of
    the batch in sync mode, vs an EWMA of accepted norms in async mode).
    Rejected updates increment per-worker QUARANTINE counters; workers
    whose counter reaches `quarantine_threshold` stop being selected.
  * ROBUST AGGREGATION -- `robust_agg` swaps the weighted average for a
    Byzantine-robust fold (trimmed mean / median / multi-Krum / norm
    clipping, aggregation.ROBUST_METHODS).  With a fog topology the
    robust fold runs per cell and again over the cell aggregates.
  * RETRY/BACKOFF -- async engines consult `retry_policy` after a
    rejection: bounded re-dispatches with exponential backoff.

The weighted average and the async fold run through the fed_agg kernel on
CUDA; `impl="ref"` sends them through its plain version instead.  With a
fog topology (`topology=`) a sync round folds edge -> fog -> cloud, one
fed_agg launch per cell and one for the cloud (core/hierarchy.py).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core import aggregation, hierarchy, selection
from repro_torch.core.cost_model import WorkerStats
from repro_torch.core.server_opt import ServerOptimizer


@dataclasses.dataclass
class ServerConfig:
    policy: str = "time_based"      # all|random|sequential|rmin_rmax|time_based
    mode: str = "sync"              # sync | async
    aggregation: str = "fedavg"     # see aggregation.aggregation_weights
    epochs_per_round: int = 2       # r (alg 2) / rmin seed (alg 1)
    random_k: int = 5
    rmin_init: float = 2.0
    rmax_init: float = 4.0
    accuracy_threshold_A: float = 0.015
    async_base_alpha: float = 0.6
    staleness_scheme: str = "polynomial"
    server_opt: str = "avg"         # avg (paper) | avgm | adam | yogi (FedOpt)
    server_lr: float = 1.0
    # -- robustness --
    robust_agg: str = "none"        # none | aggregation.ROBUST_METHODS
    trim_frac: float = 0.2          # trimmed_mean: trim ceil(frac*P)/side
    krum_f: Optional[int] = None    # krum: assumed Byzantine count
    clip_mult: float = 2.0          # norm_clip: clip at mult x median norm
    norm_outlier_mult: float = 10.0  # sanitize: reject > mult x median/EWMA
    #                                  delta norm (0 disables the norm gate)
    quarantine_threshold: int = 3   # rejections before a worker is benched
    max_retries: int = 2            # async: bounded re-dispatch after reject
    retry_backoff: float = 1.0      # async: base backoff seconds (doubling)


class AggregationServer:
    """Holds the server model + policy state; pure-python control plane."""

    def __init__(self, params, stats: dict[int, WorkerStats],
                 cfg: ServerConfig, *, seed: int = 0, topology=None,
                 impl: str = "auto"):
        if cfg.robust_agg not in ("none",) + aggregation.ROBUST_METHODS:
            raise ValueError(f"unknown robust_agg '{cfg.robust_agg}'")
        self.params = params
        self.stats = stats
        self.cfg = cfg
        # Optional hierarchy.FogTopology: sync rounds then aggregate
        # edge->fog->cloud instead of flat (numerically equivalent for
        # matching weights; see core/hierarchy.py).
        self.topology = topology
        self.impl = impl              # fed_agg path: "auto" | "ref"
        self.version = 0
        self.acc_history: list[float] = [0.0]
        self.rng = np.random.default_rng(seed)
        self._rmm = selection.RMinRMaxState(cfg.rmin_init, cfg.rmax_init)
        self._tb = selection.TimeBasedState(
            T=0.0, r=cfg.epochs_per_round, A=cfg.accuracy_threshold_A)
        self._sopt = ServerOptimizer(cfg.server_opt, lr=cfg.server_lr)
        self._sopt_state = self._sopt.init(params)
        # -- sanitization gate state --
        self.quarantine: dict[int, int] = {}    # wid -> rejection count
        self.rejections: list[tuple[int, int, str]] = []  # (version, wid, why)
        self._norm_ewma: Optional[float] = None  # async accepted-norm EWMA
        self._norm_beta = 0.3

    # ---- selection ----
    def _eligible(self) -> dict[int, WorkerStats]:
        thr = self.cfg.quarantine_threshold
        if thr <= 0 or not self.quarantine:
            return self.stats
        return {w: s for w, s in self.stats.items()
                if self.quarantine.get(w, 0) < thr}

    def select(self) -> list[int]:
        c = self.cfg
        stats = self._eligible()
        if c.policy == "all":
            return selection.select_all(stats)
        if c.policy == "sequential":
            # the paper's sequential baseline: the single worker holding data
            with_data = [w for w, s in stats.items() if s.n_data > 0]
            return with_data[:1]
        if c.policy == "random":
            return selection.select_random(stats, c.random_k, self.rng)
        if c.policy == "rmin_rmax":
            return selection.rmin_rmax_select(stats, self._rmm)
        if c.policy == "time_based":
            return selection.time_based_select(stats, self._tb)
        if c.policy == "fastest":
            return selection.select_fastest(stats, c.random_k,
                                            c.epochs_per_round)
        raise ValueError(f"unknown policy {c.policy}")

    def epochs_for(self, wid: int, round_budget: Optional[float] = None) -> int:
        if self.cfg.policy == "rmin_rmax" and round_budget is not None:
            return selection.epochs_for_worker(self.stats[wid], self._rmm,
                                               round_budget)
        return self.cfg.epochs_per_round

    # ---- sanitization gate ----
    def _reject(self, wid: int, why: str):
        self.quarantine[wid] = self.quarantine.get(wid, 0) + 1
        self.rejections.append((self.version, wid, why))

    def note_divergence(self, wid: int):
        """A worker reported a non-finite local step (it skipped and sent
        nothing); feed the quarantine counter so repeat offenders are
        benched like any other rejected sender."""
        self._reject(wid, "local_divergence")

    def sanitize_sync(self, responses: dict[int, object]
                      ) -> dict[int, object]:
        """Drop non-finite responses, then responses whose delta norm from
        the current model exceeds `norm_outlier_mult` x the batch median.
        Quarantine counters record every rejection."""
        finite: dict[int, object] = {}
        for wid, p in responses.items():
            if aggregation.tree_finite(p):
                finite[wid] = p
            else:
                self._reject(wid, "non_finite")
        mult = self.cfg.norm_outlier_mult
        if mult <= 0 or len(finite) < 3:
            return finite
        norms = {w: aggregation.delta_norm(p, self.params)
                 for w, p in finite.items()}
        med = float(np.median(list(norms.values())))
        out: dict[int, object] = {}
        for wid, p in finite.items():
            if med > 0 and norms[wid] > mult * med:
                self._reject(wid, "norm_outlier")
            else:
                out[wid] = p
        return out

    def sanitize_async(self, wid: int, worker_params) -> bool:
        """Gate one async response; True = fold it.  The norm reference is
        an EWMA of previously ACCEPTED delta norms (there is no batch to
        take a median over)."""
        if not aggregation.tree_finite(worker_params):
            self._reject(wid, "non_finite")
            return False
        mult = self.cfg.norm_outlier_mult
        if mult > 0:
            norm = aggregation.delta_norm(worker_params, self.params)
            if self._norm_ewma is not None and self._norm_ewma > 0 \
                    and norm > mult * self._norm_ewma:
                self._reject(wid, "norm_outlier")
                return False
            self._norm_ewma = norm if self._norm_ewma is None else \
                (1 - self._norm_beta) * self._norm_ewma + \
                self._norm_beta * norm
        return True

    def retry_policy(self, wid: int, n_rejects: int
                     ) -> Optional[float]:
        """After a rejected async response: seconds to wait before
        re-dispatching `wid`, or None to give up (bounded retries /
        quarantined worker)."""
        c = self.cfg
        if n_rejects > c.max_retries:
            return None
        if self.quarantine.get(wid, 0) >= c.quarantine_threshold > 0:
            return None
        return c.retry_backoff * (2.0 ** max(n_rejects - 1, 0))

    # ---- aggregation ----
    def _robust_avg(self, responses: dict[int, object], wids: list[int]):
        c = self.cfg
        kw = dict(trim_frac=c.trim_frac, krum_f=c.krum_f,
                  clip_mult=c.clip_mult)
        kw = {k: v for k, v in kw.items() if v is not None}
        if c.robust_agg == "norm_clip":
            kw["base"] = self.params
        if self.topology is not None:
            return hierarchy.fog_aggregate_responses(
                responses, {w: max(self.stats[w].n_data, 1) for w in wids},
                self.topology, robust=c.robust_agg, robust_kw=kw,
                impl=self.impl)
        return aggregation.robust_aggregate(
            [responses[w] for w in wids], c.robust_agg, **kw)

    def sync_aggregate(self, responses: dict[int, object], sim_time: float):
        """responses: wid -> worker params (all based on self.version).
        Every response passes the sanitization gate first; the surviving
        set is folded with the configured (robust or weighted) aggregator.
        """
        responses = self.sanitize_sync(responses)
        if not responses:
            return
        wids = sorted(responses)
        w = aggregation.aggregation_weights(
            self.cfg.aggregation,
            [max(self.stats[i].n_data, 1) for i in wids],
            staleness=[0.0] * len(wids))
        avg = None
        if self.cfg.robust_agg != "none":
            avg = self._robust_avg(responses, wids)
        elif self.topology is not None:
            avg = hierarchy.fog_aggregate_responses(
                responses, dict(zip(wids, w)), self.topology, impl=self.impl)
        self.params, self._sopt_state = self._sopt.apply(
            self.params, [responses[i] for i in wids], w, self._sopt_state,
            avg=avg, impl=self.impl)
        for i in wids:
            self.stats[i].last_contribution = sim_time
        self.version += 1

    def async_fold(self, wid: int, worker_params, base_version: int,
                   sim_time: float) -> bool:
        """Fold one response if it passes the gate; returns True when the
        model advanced (False = rejected, caller may consult
        `retry_policy`)."""
        if not self.sanitize_async(wid, worker_params):
            return False
        staleness = self.version - base_version
        alpha = aggregation.staleness_alpha(
            self.cfg.async_base_alpha, staleness,
            scheme=self.cfg.staleness_scheme)
        self.params = aggregation.async_merge(self.params, worker_params,
                                              alpha, impl=self.impl)
        self.stats[wid].last_contribution = sim_time
        self.version += 1
        return True

    # ---- policy feedback (Eq. 1-3) ----
    def record_accuracy(self, acc: float):
        prev = self.acc_history[-1]
        self.acc_history.append(acc)
        if self.cfg.policy == "rmin_rmax":
            self._rmm = selection.rmin_rmax_update(self._rmm, acc)
        elif self.cfg.policy == "time_based":
            st = dataclasses.replace(self._tb, acc_prev=prev)
            self._tb = selection.time_based_update(self.stats, st, acc)

    @property
    def policy_state(self):
        if self.cfg.policy == "rmin_rmax":
            return self._rmm
        if self.cfg.policy == "time_based":
            return self._tb
        return None

    # ---- control-plane state (the checkpoint manager saves params) ----
    def state_dict(self) -> dict:
        """JSON-serializable control-plane state, the reference's format."""
        return {
            "version": self.version,
            "acc_history": [float(a) for a in self.acc_history],
            "rng_state": self.rng.bit_generator.state,
            "rmm": dataclasses.asdict(self._rmm),
            "tb": dataclasses.asdict(self._tb),
            "quarantine": {str(k): int(v) for k, v in
                           self.quarantine.items()},
            "norm_ewma": self._norm_ewma,
            "sopt_step": int(self._sopt_state.step),
            "stats": {str(w): {
                "t_one": s.t_one, "t_transmit": s.t_transmit,
                "n_data": s.n_data,
                "last_contribution": s.last_contribution,
                "rounds_participated": s.rounds_participated,
            } for w, s in self.stats.items()},
        }

    def load_state_dict(self, state: dict):
        self.version = int(state["version"])
        self.acc_history = list(state["acc_history"])
        self.rng.bit_generator.state = state["rng_state"]
        self._rmm = selection.RMinRMaxState(**state["rmm"])
        self._tb = selection.TimeBasedState(**state["tb"])
        self.quarantine = {int(k): int(v) for k, v in
                           state.get("quarantine", {}).items()}
        self._norm_ewma = state.get("norm_ewma")
        self._sopt_state = dataclasses.replace(
            self._sopt_state, step=int(state.get("sopt_step", 0)))
        for w, d in state["stats"].items():
            s = self.stats.get(int(w))
            if s is None:
                continue
            s.t_one = float(d["t_one"])
            s.t_transmit = float(d["t_transmit"])
            s.n_data = int(d["n_data"])
            s.last_contribution = float(d["last_contribution"])
            s.rounds_participated = int(d["rounds_participated"])

"""Worker-selection policies (paper SSIII-D).

Algorithm 1 (R-min/R-max):  select w iff finishing its MINIMUM training
  (rmin epochs + transmit) takes no longer than the fastest worker finishing
  its MAXIMUM training (rmax epochs + transmit).  NOTE: line 11 of the
  paper's listing prints `>=`, which would select only the SLOWEST workers
  and contradicts the prose ("if a worker requires more time to train a
  minimum number of epochs compared to the worker that can finish the
  maximum number ... it is excluded"); we implement the prose (`<=`).
  Eq. 1/2 as printed are likewise swapped w.r.t. the prose (rmin must DROP
  when accuracy grows); we implement the prose and verify the paper's
  divergence pathology in benchmarks/fig15-16.

Algorithm 2 (training-time-based):  select w iff T_one_w*r + T_transmit_w
  <= T; grow T to the cheapest not-yet-selected worker's total time only
  when the round-over-round accuracy gain falls below threshold A (Eq. 3).

  Knob -> paper symbol map (Algorithm 2 / Eq. 3):
    TimeBasedState.T        T      time allowed for one round (init 0: the
                                   first update admits the single cheapest
                                   worker, exactly the paper's bootstrap)
    TimeBasedState.r        r      unified local epochs per round
    TimeBasedState.A        A      accuracy-improvement threshold; a round
                                   gaining less than A triggers Eq. 3
    TimeBasedState.acc_prev acc_1  previous round's global accuracy
                                   (acc_2 is the `acc_now` argument)
    WorkerStats.t_one       T_one      one local epoch's training time
    WorkerStats.t_transmit  T_transmit model up/down transfer time
    _total_time(s, r)       T_total    = T_one * r + T_transmit
  `time_based_select` is Algorithm 2 lines 2-6 (the admission filter);
  `time_based_update` is lines 7-12 / Eq. 3 (the growth rule), with T
  monotone non-decreasing (see its docstring for the divergence the
  literal reading causes).

Plus baselines: all / random / sequential (the paper's comparison lines).
All policies are pure functions of WorkerStats -> deterministic + testable.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np

from repro_torch.core.cost_model import WorkerStats


# --------------------------------------------------------------------------
# Algorithm 1: R-min / R-max
# --------------------------------------------------------------------------

@dataclasses.dataclass
class RMinRMaxState:
    rmin: float
    rmax: float
    acc_prev: float = 0.0


def rmin_rmax_select(stats: Mapping[int, WorkerStats],
                     state: RMinRMaxState) -> list[int]:
    if not stats:
        return []
    t_min = {w: s.t_one * state.rmin + s.t_transmit for w, s in stats.items()}
    t_max = {w: s.t_one * state.rmax + s.t_transmit for w, s in stats.items()}
    t_minimum = min(t_max.values())
    sel = [w for w in stats if t_min[w] <= t_minimum]
    return sorted(sel)


def rmin_rmax_update(state: RMinRMaxState, acc_now: float) -> RMinRMaxState:
    """Eq. 1/2 (prose direction): accuracy growth shrinks rmin, grows rmax.
    Accuracies are fractions in [0,1]; the +1 damping is the paper's guard
    against early-training surges."""
    ratio = (state.acc_prev + 1.0) / (acc_now + 1.0)
    rmin = max(1.0, state.rmin * ratio)
    rmax = max(rmin, state.rmax / ratio)
    return RMinRMaxState(rmin=rmin, rmax=rmax, acc_prev=acc_now)


def epochs_for_worker(stats: WorkerStats, state: RMinRMaxState,
                      budget: float) -> int:
    """Fast workers train extra epochs (up to rmax) within the round budget."""
    if stats.t_one <= 0:
        return int(round(state.rmax))
    r = int((budget - stats.t_transmit) / stats.t_one)
    return int(np.clip(r, max(1, round(state.rmin)), max(1, round(state.rmax))))


# --------------------------------------------------------------------------
# Algorithm 2: training-time-based
# --------------------------------------------------------------------------

@dataclasses.dataclass
class TimeBasedState:
    T: float = 0.0            # time allowed for a round (init 0 per paper)
    r: int = 2                # unified local epochs per round
    A: float = 0.005          # accuracy-improvement threshold (fraction)
    acc_prev: float = 0.0


def _total_time(s: WorkerStats, r: int) -> float:
    return s.t_one * r + s.t_transmit


def time_based_select(stats: Mapping[int, WorkerStats],
                      state: TimeBasedState) -> list[int]:
    sel = [w for w, s in stats.items() if _total_time(s, state.r) <= state.T]
    return sorted(sel)


def time_based_update(stats: Mapping[int, WorkerStats],
                      state: TimeBasedState, acc_now: float) -> TimeBasedState:
    """Eq. 3: admit the cheapest unselected worker when accuracy stalls.

    T is MONOTONE non-decreasing (the paper: 'more workers are included
    ... achieved by increasing the time limit').  Without the max(), a
    worker whose MEASURED time drifts above the fixed T drops back out and
    the pool oscillates at 3-4 workers instead of growing (observed;
    EXPERIMENTS.md SSPaper-validation)."""
    new = dataclasses.replace(state, acc_prev=acc_now)
    if acc_now - state.acc_prev < state.A:
        selected = set(time_based_select(stats, state))
        unselected = [s for w, s in stats.items() if w not in selected]
        if unselected:
            new = dataclasses.replace(
                new, T=max(state.T,
                           min(_total_time(s, state.r) for s in unselected)))
    return new


# --------------------------------------------------------------------------
# Baselines
# --------------------------------------------------------------------------

def select_all(stats: Mapping[int, WorkerStats]) -> list[int]:
    return sorted(stats)


def select_random(stats: Mapping[int, WorkerStats], k: int,
                  rng: np.random.Generator) -> list[int]:
    ids = sorted(stats)
    k = min(k, len(ids))
    return sorted(rng.choice(ids, size=k, replace=False).tolist())


def select_fastest(stats: Mapping[int, WorkerStats], k: int,
                   r: int = 1) -> list[int]:
    """Power-of-choice style latency-greedy baseline (beyond-paper)."""
    ranked = sorted(stats.values(), key=lambda s: _total_time(s, r))
    return sorted(s.wid for s in ranked[:k])


def select_utility(stats: Mapping[int, WorkerStats], k: int, *,
                   utilities: Mapping[int, float], r: int = 2,
                   explore: float = 0.1,
                   rng: np.random.Generator | None = None) -> list[int]:
    """Oort-style utility selection (beyond-paper): rank workers by
    statistical utility (e.g. recent local loss x sqrt(data)) divided by
    their round time, with an epsilon of random exploration so slow/unseen
    workers are still sampled.  Degrades to select_fastest when utilities
    are uniform."""
    ids = sorted(stats)
    if not ids:
        return []
    k = min(k, len(ids))
    rng = rng or np.random.default_rng(0)
    score = {
        w: (utilities.get(w, 1.0) * np.sqrt(max(stats[w].n_data, 1))
            / max(_total_time(stats[w], r), 1e-6))
        for w in ids
    }
    ranked = sorted(ids, key=lambda w: -score[w])
    n_exploit = max(1, int(round(k * (1 - explore))))
    chosen = ranked[:n_exploit]
    rest = [w for w in ids if w not in chosen]
    if rest and k > n_exploit:
        extra = rng.choice(rest, size=min(k - n_exploit, len(rest)),
                           replace=False).tolist()
        chosen = chosen + list(extra)
    return sorted(chosen)

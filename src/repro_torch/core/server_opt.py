"""Server-side optimizers for federated aggregation (beyond-paper), port of
`repro.core.server_opt`.

The paper folds worker weights by plain (weighted) averaging.  FedOpt
(Reddi et al. 2021) instead treats the average worker DELTA as a
pseudo-gradient and applies a server optimizer -- FedAvgM / FedAdam /
FedYogi.  The average itself is the fed_agg kernel's weighted merge.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import aggregation
from repro_torch.tree import tree_map


@dataclasses.dataclass
class ServerOptState:
    momentum: object = None       # tree like params (fp32)
    variance: object = None       # tree like params (adam/yogi, fp32)
    step: int = 0


@dataclasses.dataclass
class ServerOptimizer:
    """method: 'avg' (paper) | 'avgm' | 'adam' | 'yogi'."""
    method: str = "avg"
    lr: float = 1.0
    beta1: float = 0.9
    beta2: float = 0.99
    eps: float = 1e-3

    def init(self, params) -> ServerOptState:
        z = lambda: tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
        if self.method == "avg":
            return ServerOptState()
        if self.method == "avgm":
            return ServerOptState(momentum=z())
        return ServerOptState(momentum=z(), variance=z())

    def apply(self, server_params, worker_params_list, weights,
              state: ServerOptState, *, avg=None, impl: str = "auto"):
        """-> (new_server_params, new_state).  worker list is the selected
        responses; weights as in aggregation.aggregation_weights.  `avg`
        short-circuits the flat weighted average when the caller already
        aggregated (the robust fold); `impl` selects fed_agg's path."""
        if avg is None:
            avg = aggregation.weighted_average(worker_params_list, weights,
                                               impl=impl)
        if self.method == "avg":
            return avg, state

        b1, b2 = self.beta1, self.beta2
        delta = tree_map(lambda a, s: a.float() - s.float(), avg,
                         server_params)
        m = tree_map(lambda mo, d: b1 * mo + (1 - b1) * d,
                     state.momentum, delta)
        if self.method == "avgm":
            new = tree_map(lambda s, mo: (s.float() + self.lr * mo).to(s.dtype),
                           server_params, m)
            return new, ServerOptState(momentum=m, step=state.step + 1)

        if self.method == "adam":
            v = tree_map(lambda vo, d: b2 * vo + (1 - b2) * d * d,
                         state.variance, delta)
        elif self.method == "yogi":
            v = tree_map(lambda vo, d: vo - (1 - b2) * d * d
                         * torch.sign(vo - d * d), state.variance, delta)
        else:
            raise ValueError(self.method)
        new = tree_map(
            lambda s, mo, vo: (s.float() + self.lr * mo
                               / (torch.sqrt(vo) + self.eps)).to(s.dtype),
            server_params, m, v)
        return new, ServerOptState(momentum=m, variance=v,
                                   step=state.step + 1)

"""Seeded fault injection: deterministic, replayable corruption of the
federated control plane, port of `repro.core.faults`.

A `FaultPlan` derived from a `FaultConfig` makes every fault decision a
pure function of (seed, worker id, round): two runs with the same plan
inject byte-identical faults regardless of call order.  The draws are the
reference's numpy generators, keyed the same way, so the port and the JAX
package make the same decisions and draw the same noise and masks.

Fault taxonomy (all opt-in, default rates 0):

  * BYZANTINE UPDATES -- a fixed seed-chosen subset of workers ships
    corrupted weights every time it participates:
      - ``nan`` / ``inf``  : non-finite entries sprayed into the update
      - ``sign_flip``      : w' = base - (w - base)   (reflected delta)
      - ``scale``          : w' = base + s * (w - base), s >> 1
      - ``noise``          : additive Gaussian noise on the update
      - ``stale``          : stale-base replay (resends the dispatch base)
  * RESPONSE FAULTS -- per (worker, round): drop (message lost) or
    duplicate (message folded twice; async engines re-deliver).
  * WORKER CRASH -- per (worker, round): the worker dies mid-round and
    restarts; its response for the round is lost.
  * SERVER CRASH -- at configured rounds the aggregation server process
    is killed mid-round (engines return SimResult(crashed=True)).

Defenses live elsewhere: `aggregation.robust_aggregate*`, the server's
sanitization gate (`server.AggregationServer`), and `finite_members`, the
island exchange's gate.  This module only BREAKS things, deterministically.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.tree import leaves, tree_map, unflatten_like

ATTACKS = ("nan", "inf", "sign_flip", "scale", "noise", "stale")

# domain-separation constants for the counter-based draws
_BYZ, _ATK, _FATE, _CRASH, _NOISE = 9176, 4391, 5281, 6733, 8269


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Rates and shapes of the injected faults (all per response/round)."""
    byzantine_frac: float = 0.0          # fixed fraction of Byzantine workers
    attacks: tuple = ("sign_flip", "scale")   # pool Byzantine workers draw from
    scale_factor: float = 10.0           # blow-up for the "scale" attack
    noise_std: float = 1.0               # std for the "noise" attack
    nonfinite_frac: float = 0.01         # entry fraction hit by nan/inf
    drop_frac: float = 0.0               # P(response lost) per round
    duplicate_frac: float = 0.0          # P(response delivered twice)
    worker_crash_frac: float = 0.0       # P(worker crash-restarts) per round
    server_crash_rounds: tuple = ()      # rounds where the server is killed
    seed: int = 0


class FaultPlan:
    """Deterministic fault schedule.  Every method is a pure function of
    the config seed and its arguments -- replayable, order-independent."""

    def __init__(self, cfg: FaultConfig):
        for a in cfg.attacks:
            if a not in ATTACKS:
                raise ValueError(f"unknown attack '{a}' (have {ATTACKS})")
        self.cfg = cfg

    # -- decision draws (counter-based, order-independent) -----------------
    def _rng(self, *key: int) -> np.random.Generator:
        return np.random.default_rng((self.cfg.seed,) + tuple(
            int(k) for k in key))

    def is_byzantine(self, wid: int) -> bool:
        c = self.cfg
        if c.byzantine_frac <= 0:
            return False
        return bool(self._rng(_BYZ, wid).random() < c.byzantine_frac)

    def attack_for(self, wid: int) -> str:
        atk = self.cfg.attacks
        return atk[int(self._rng(_ATK, wid).integers(len(atk)))]

    def response_fate(self, wid: int, rnd: int) -> str:
        """'deliver' | 'drop' | 'duplicate' for this worker's response.
        A worker crash also loses the response ('drop', crash flavor)."""
        c = self.cfg
        if c.worker_crash_frac > 0 and \
                self._rng(_CRASH, wid, rnd).random() < c.worker_crash_frac:
            return "drop"
        u = self._rng(_FATE, wid, rnd).random()
        if u < c.drop_frac:
            return "drop"
        if u < c.drop_frac + c.duplicate_frac:
            return "duplicate"
        return "deliver"

    def server_crashes(self, rnd: int) -> bool:
        return int(rnd) in set(int(r) for r in self.cfg.server_crash_rounds)

    # -- update corruption -------------------------------------------------
    def corrupt(self, params, base, wid: int, rnd: int):
        """Byzantine-corrupt one response (tree) relative to the model
        `base` it was trained from.  Identity for honest workers."""
        if not self.is_byzantine(wid):
            return params
        attack = self.attack_for(wid)
        c = self.cfg

        if attack == "stale":
            return tree_map(lambda b, p: b.to(p.dtype, copy=True),
                            base, params)

        def one(p, b, leaf_i):
            p32, b32 = p.float(), b.float()
            if attack == "sign_flip":
                out = b32 - (p32 - b32)
            elif attack == "scale":
                out = b32 + c.scale_factor * (p32 - b32)
            elif attack == "noise":
                rng = self._rng(_NOISE, wid, rnd, leaf_i)
                noise = rng.normal(0.0, c.noise_std, tuple(p.shape))
                out = p32 + torch.from_numpy(
                    noise.astype(np.float32)).to(p.device)
            elif attack in ("nan", "inf"):
                rng = self._rng(_NOISE, wid, rnd, leaf_i)
                mask = rng.random(tuple(p.shape)) < c.nonfinite_frac
                mask.flat[0] = True          # at least one poisoned entry
                bad = float("nan") if attack == "nan" else float("inf")
                out = torch.where(torch.from_numpy(mask).to(p.device),
                                  bad, p32)
            else:  # pragma: no cover -- attacks validated in __init__
                raise ValueError(attack)
            return out.to(p.dtype)

        return unflatten_like(params, [
            one(p, b, i) for i, (p, b)
            in enumerate(zip(leaves(params), leaves(base)))])

    def corrupt_stacked(self, stacked, base, wids: Sequence[int], rnd: int):
        """Corrupt members of a stacked (C, ...) cohort tree in place of
        their leading-axis slices.  `base` is the shared dispatch model
        (unstacked).  Honest members pass through untouched; the input
        tree is never written."""
        bad = [(i, int(w)) for i, w in enumerate(wids)
               if self.is_byzantine(int(w))]
        if not bad:
            return stacked
        stacked = tree_map(torch.clone, stacked)
        for i, wid in bad:
            sub = self.corrupt(tree_map(lambda x: x[i], stacked), base,
                               wid, rnd)
            for s, c in zip(leaves(stacked), leaves(sub)):
                s[i] = c
        return stacked

    # -- bookkeeping -------------------------------------------------------
    def byzantine_in(self, wids: Sequence[int]) -> list[int]:
        return [int(w) for w in wids if self.is_byzantine(int(w))]


def finite_members(stacked) -> np.ndarray:
    """(C,) bool: member i's slice has only finite entries in every leaf.
    The stacked half of the server's sanitization gate (one host sync)."""
    ls = leaves(stacked)
    if not ls:
        return np.zeros(0, bool)
    C = ls[0].shape[0]
    ok = torch.stack([torch.isfinite(l.float()).reshape(C, -1).all(dim=1)
                      for l in ls]).all(dim=0)
    return ok.cpu().numpy()

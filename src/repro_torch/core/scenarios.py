"""Scalable FL scenario engine: churn / stragglers / non-IID drift /
partial participation at 10^5+ simulated workers, port of
`repro.core.scenarios`.

The discrete-event engine (`core/events.py`) instantiates a SimWorker per
worker and trains each one -- faithful, but capped at a few dozen workers.
This engine splits the two things a federated simulation must produce:

  * TIMING runs over the FULL population as vectorized numpy: per-worker
    ground-truth times are arrays, a sync round is one masked max (the
    straggler barrier), async is a finish-time heap seeded with the whole
    participating set.  10^5 workers is a few array ops per round.  These
    are the reference's numpy streams, draw for draw, so the time /
    round / n_selected / version columns equal the JAX engine's exactly.
  * QUALITY comes from really training a SAMPLED COHORT with the batched
    vmap step (`client.LocalTrainer.train_cohort`) on freshly drawn
    non-IID shards, folded through the edge->fog->cloud hierarchy
    (`core.hierarchy`).  The cohort stands in for the round's selected set
    the way a survey samples a population.  Shards are drawn on the host
    and copied to the device once per cohort; the test set lives on the
    device.

Adversarial faults ride the same cohort path: with `byzantine_frac` set, a
seeded `faults.FaultPlan` corrupts the Byzantine members' slices of the
stacked cohort tree before the fold; non-finite members are rejected by
the sanitization scan (quarantine counters in `self.quarantine`), and
`robust_agg` swaps the weighted hierarchical fold for the Byzantine-robust
one (`hierarchy.hierarchical_robust_aggregate`).  `server_crash_round`
kills the run mid-round (SimResult.crashed) -- with a CheckpointManager
attached, `run_sync/run_async(resume=True)` continues from the last
round-granular checkpoint with a bit-identical SimRecord stream, in the
reference's checkpoint format (either package resumes the other's).

Every async merge is one `fed_agg` launch on the card (`impl="ref"` sends
it through the plain version); the sync fold is two mixing contractions.
Every random draw comes from seeded generators (numpy for the population,
a split Threefry key chain for training), so two runs with the same config
produce IDENTICAL SimRecord sequences.
"""
from __future__ import annotations

import dataclasses
import heapq

import numpy as np
import torch

from repro_torch import threefry
from repro_torch.checkpoint.manager import load_pytree
from repro_torch.core import aggregation, federated, hierarchy
from repro_torch.core import faults as faults_mod
from repro_torch.core.client import LocalTrainer
from repro_torch.core.events import SimRecord, SimResult
from repro_torch.data.synthetic import make_classification_set
from repro_torch.models import build_model
from repro_torch.models.config import ModelConfig
from repro_torch.runtime import resolve_device
from repro_torch.tree import tree_map

_DEFAULT_MODEL = ModelConfig(name="scenario-mlp", family="cnn", num_layers=0,
                             d_model=48, img_hw=28, img_c=1, n_classes=10,
                             remat=False)


@dataclasses.dataclass(frozen=True)
class ScenarioConfig:
    """Knobs for one scenario.  All rates are per round (sync) or per
    cohort-generation (async)."""
    n_workers: int = 1000
    cohort_size: int = 16          # workers actually trained per round
    fog_cells: int = 4             # edge->fog->cloud cells over the cohort
    participation: float = 0.1     # fraction of ALIVE workers selected
    churn_leave: float = 0.0       # P(online worker drops) per round
    churn_join: float = 0.0        # P(offline worker rejoins) per round
    straggler_frac: float = 0.0    # fraction with a heavy-tail slowdown
    straggler_slow: float = 8.0    # their multiplicative slowdown
    drift: float = 0.0             # label-skew rotation speed (classes/round)
    dirichlet_alpha: float = 100.0  # >=100 => IID; small => label-skewed
    epochs: int = 1
    samples_per_worker: int = 64
    batch_size: int = 32
    t_per_sample: float = 2e-3     # reference seconds per sample per epoch
    round_overhead: float = 0.5
    idle_tick: float = 0.2
    async_base_alpha: float = 0.6
    staleness_scheme: str = "polynomial"
    # -- faults + defenses (core/faults.py, aggregation.ROBUST_METHODS) --
    byzantine_frac: float = 0.0    # seed-chosen fraction of corrupt workers
    byzantine_attacks: tuple = ("sign_flip", "scale")
    byzantine_scale: float = 10.0  # blow-up for the "scale" attack
    robust_agg: str = "none"       # none | trimmed_mean | median | krum |
    #                                norm_clip (hierarchical robust fold)
    trim_frac: float = 0.2         # trimmed_mean: trim ceil(frac*P)/side
    server_crash_round: int = 0    # kill the server at this round/merge
    #                                (0 = never; resume via checkpoints)
    seed: int = 0


class ScenarioSim:
    """Population-scale FL simulation (see module docstring).

    run_sync / run_async mirror events.FLSimulation's API and return the
    same SimResult record stream.  `device`: where params, training and
    evaluation live (the card unless "cpu" is asked for); `impl`: the
    async merge's fed_agg path ("auto" | "ref")."""

    def __init__(self, cfg: ScenarioConfig, *, model_cfg: ModelConfig = None,
                 pool: int = 4096, eval_n: int = 512, ckpt=None,
                 ckpt_every: int = 1, device="cuda", impl: str = "auto"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.impl = impl
        self.model = build_model(model_cfg or _DEFAULT_MODEL)
        self.trainer = LocalTrainer(self.model, lr=0.05,
                                    batch_size=cfg.batch_size)
        self.pool_x, self.pool_y = make_classification_set(
            "synmnist", pool, seed=cfg.seed + 1)
        test_x, test_y = make_classification_set(
            "synmnist", eval_n, seed=cfg.seed + 2)
        self.test_x = torch.as_tensor(test_x, device=self.device)
        self.test_y = torch.as_tensor(test_y, device=self.device)
        self.n_classes = int(self.pool_y.max()) + 1
        self._class_idx = [np.flatnonzero(self.pool_y == c)
                           for c in range(self.n_classes)]
        if cfg.robust_agg not in ("none",) + aggregation.ROBUST_METHODS:
            raise ValueError(f"unknown robust_agg '{cfg.robust_agg}'")
        if cfg.byzantine_frac > 0 or cfg.server_crash_round > 0:
            self.faults = faults_mod.FaultPlan(faults_mod.FaultConfig(
                byzantine_frac=cfg.byzantine_frac,
                attacks=tuple(cfg.byzantine_attacks),
                scale_factor=cfg.byzantine_scale,
                server_crash_rounds=(cfg.server_crash_round,)
                if cfg.server_crash_round > 0 else (),
                seed=cfg.seed))
        else:
            self.faults = None
        self.quarantine: dict[int, int] = {}  # wid -> rejected updates
        self.ckpt = ckpt               # Optional checkpoint.CheckpointManager
        self.ckpt_every = max(int(ckpt_every), 1)

        # -- full-population ground truth (vectorized) -------------------
        n = cfg.n_workers
        rng = np.random.default_rng(cfg.seed + 23)
        speed = rng.lognormal(0.0, 0.25, n)
        slow = np.where(rng.random(n) < cfg.straggler_frac,
                        cfg.straggler_slow, 1.0)
        self.t_one = cfg.t_per_sample * cfg.samples_per_worker * speed * slow
        self.t_tx = rng.uniform(0.05, 0.3, n)
        self.alive = np.ones(n, bool)
        self.rng = np.random.default_rng(cfg.seed)     # selection + churn
        self.key = threefry.key(cfg.seed)

    # -- helpers -----------------------------------------------------------
    def _init_params(self):
        return self.model.init(threefry.key(self.cfg.seed), self.device)

    def _next_key(self):
        self.key, k = threefry.split(self.key)
        return k

    def _churn(self):
        c = self.cfg
        if c.churn_leave > 0:
            self.alive &= ~(self.rng.random(len(self.alive)) < c.churn_leave)
        if c.churn_join > 0:
            joins = self.rng.random(len(self.alive)) < c.churn_join
            self.alive |= joins

    def _select(self) -> np.ndarray:
        alive_idx = np.flatnonzero(self.alive)
        if alive_idx.size == 0:
            return alive_idx
        n_sel = max(1, int(round(self.cfg.participation * alive_idx.size)))
        return np.sort(self.rng.choice(alive_idx, n_sel, replace=False))

    def _label_props(self, wid: int) -> np.ndarray:
        if self.cfg.dirichlet_alpha >= 100.0:
            return np.full(self.n_classes, 1.0 / self.n_classes)
        rw = np.random.default_rng((self.cfg.seed, 104729, int(wid)))
        return rw.dirichlet([self.cfg.dirichlet_alpha] * self.n_classes)

    def shard_for(self, wid: int, rnd: int):
        """Worker `wid`'s private shard at round `rnd` (host numpy): label
        proportions are a per-worker Dirichlet draw rotated by the drift
        schedule, so a non-stationary fleet keeps re-skewing as the
        simulation advances."""
        shift = int(self.cfg.drift * rnd) % self.n_classes
        props = np.roll(self._label_props(wid), shift)
        rs = np.random.default_rng((self.cfg.seed, 7919, int(wid), shift))
        counts = rs.multinomial(self.cfg.samples_per_worker, props)
        idx = np.concatenate([
            rs.choice(self._class_idx[c], k, replace=True)
            for c, k in enumerate(counts) if k > 0])
        rs.shuffle(idx)
        return self.pool_x[idx], self.pool_y[idx]

    # -- fault injection + sanitization + fold -----------------------------
    def _inject_and_sanitize(self, params, stacked, cohort: np.ndarray,
                             rnd: int):
        """Corrupt the Byzantine members' slices, then reject (drop +
        quarantine-count) any member whose slice went non-finite.  Returns
        (stacked, cohort) restricted to the surviving members -- possibly
        empty."""
        stacked = self.faults.corrupt_stacked(stacked, params, cohort, rnd)
        ok = faults_mod.finite_members(stacked)
        if ok.all():
            return stacked, cohort
        for w in cohort[~ok]:
            self.quarantine[int(w)] = self.quarantine.get(int(w), 0) + 1
        keep = np.flatnonzero(ok)
        if keep.size == 0:
            return None, cohort[:0]
        keep_t = torch.as_tensor(keep, device=self.device)
        return tree_map(lambda l: l[keep_t], stacked), cohort[keep]

    def _fold_cohort(self, params, stacked, cohort: np.ndarray):
        """Fold the surviving cohort edge->fog->cloud: the robust fold
        when `robust_agg` is set (unweighted -- see
        aggregation.robust_aggregate_stacked), the exact weighted
        hierarchy otherwise."""
        c = self.cfg
        cell_of = np.asarray(cohort) % max(1, c.fog_cells)
        if c.robust_agg != "none":
            folded = hierarchy.hierarchical_robust_aggregate(
                stacked, cell_of, c.robust_agg, base=params,
                trim_frac=c.trim_frac)
            return tree_map(lambda a, p: a.to(p.dtype), folded, params)
        weights = np.full(len(cohort), float(c.samples_per_worker))
        folded = hierarchy.hierarchical_sync_aggregate(stacked, weights,
                                                       cell_of)
        return federated.island_slice(folded, 0)

    def _train_members(self, params, cohort: np.ndarray, rnd: int):
        """Train the cohort in one vmapped step (one key per member, split
        in cohort order before training), then inject faults and sanitize.
        -> (stacked, cohort) of the survivors; stacked None when the whole
        cohort was rejected."""
        shards = [self.shard_for(int(w), rnd) for w in cohort]
        keys = [self._next_key() for _ in cohort]
        stacked = federated.cohort_train(self.trainer, params, shards, keys,
                                         self.cfg.epochs)
        if self.faults is not None:
            stacked, cohort = self._inject_and_sanitize(params, stacked,
                                                        cohort, rnd)
        return stacked, cohort

    def _train_cohort(self, params, cohort: np.ndarray, rnd: int):
        """One vmapped batched step over the sampled cohort, folded
        edge->fog->cloud.  Returns the new global params."""
        stacked, cohort = self._train_members(params, cohort, rnd)
        if stacked is None:          # whole cohort rejected: no progress
            return params
        return self._fold_cohort(params, stacked, cohort)

    def _eval(self, params) -> float:
        return self.trainer.evaluate(params, self.test_x, self.test_y)

    # -- crash-safe state --------------------------------------------------
    def _save_state(self, kind: str, step: int, t: float, last_acc: float,
                    params, version: int, *, heap=(), members=(),
                    base_version: int = 0, seq: int = 0, merges: int = 0):
        if self.ckpt is None:
            return
        state = {"key": self.key, "alive": self.alive}
        for i, m in enumerate(members):
            state[f"m{i}"] = m
        extra = {"kind": kind, "step": int(step), "t": float(t),
                 "last_acc": float(last_acc), "version": int(version),
                 "rng_state": self.rng.bit_generator.state,
                 "quarantine": {str(k): int(v)
                                for k, v in self.quarantine.items()},
                 "heap": [[float(f), int(s), int(w)]
                          for f, s, w in sorted(heap)],
                 "n_members": len(members), "base_version": int(base_version),
                 "seq": int(seq), "merges": int(merges)}
        self.ckpt.save(step, params=params, opt_state=state, extra=extra)

    def _restore_state(self, kind: str) -> dict:
        """The latest checkpoint: params and in-flight members in the
        model's dtypes on this sim's device; the key, `alive` and the
        numpy stream restored in place."""
        template = self._init_params()
        step, params, _, extra = self.ckpt.restore(params_like=template,
                                                   device=self.device)
        if extra.get("kind") != kind:
            raise ValueError(f"checkpoint at step {step} is a "
                             f"'{extra.get('kind')}' run, not '{kind}'")
        n_members = int(extra.get("n_members", 0))
        like = {"key": self.key, "alive": self.alive}
        for i in range(n_members):
            like[f"m{i}"] = template
        state = load_pytree(self.ckpt.path_for(step) / "opt_state.npz", like,
                            device=self.device)
        self.key = np.asarray(state["key"], np.uint32)
        self.alive = np.asarray(state["alive"], bool)
        self.rng.bit_generator.state = extra["rng_state"]
        self.quarantine = {int(k): int(v) for k, v in
                           extra.get("quarantine", {}).items()}
        members = [state[f"m{i}"] for i in range(n_members)]
        heap = [(float(f), int(s), int(w))
                for f, s, w in extra.get("heap", [])]
        heapq.heapify(heap)
        return {"step": step, "params": params, "t": float(extra["t"]),
                "last_acc": float(extra["last_acc"]),
                "version": int(extra["version"]), "heap": heap,
                "members": members,
                "base_version": int(extra["base_version"]),
                "seq": int(extra["seq"]), "merges": int(extra["merges"])}

    def _crashes(self, rnd: int, skip: int) -> bool:
        return self.faults is not None and self.faults.server_crashes(rnd) \
            and rnd != skip

    # -- synchronous -------------------------------------------------------
    def run_sync(self, rounds: int, *, max_time: float = np.inf,
                 resume: bool = False) -> SimResult:
        c = self.cfg
        skip_crash = -1
        if resume and self.ckpt is not None and \
                self.ckpt.latest_step() is not None:
            st = self._restore_state("scen_sync")
            params, t, start = st["params"], st["t"], st["step"]
            version, last_acc = st["version"], st["last_acc"]
            recs: list[SimRecord] = []
            if c.server_crash_round > start:
                skip_crash = c.server_crash_round  # the crash that killed us
        else:
            params = self._init_params()
            t, start, version = 0.0, 0, 0
            last_acc = self._eval(params)
            recs = [SimRecord(0.0, last_acc, 0, 0, 0)]
        for rnd in range(start + 1, rounds + 1):
            self._churn()
            sel = self._select()
            if sel.size == 0:
                t += c.idle_tick
                recs.append(SimRecord(t, last_acc, rnd, 0, version))
                if self.ckpt and rnd % self.ckpt_every == 0:
                    self._save_state("scen_sync", rnd, t, last_acc, params,
                                     version)
                continue
            # straggler barrier over the FULL selected set (vectorized)
            t += float((self.t_one[sel] * c.epochs + self.t_tx[sel]).max()) \
                + c.round_overhead
            cohort = np.sort(self.rng.choice(
                sel, min(c.cohort_size, sel.size), replace=False))
            params = self._train_cohort(params, cohort, rnd)
            version += 1
            if self._crashes(rnd, skip_crash):
                # killed mid-round: the round is lost (no record, no
                # checkpoint); resume replays it from the last checkpoint
                return SimResult(recs, params, crashed=True)
            last_acc = self._eval(params)
            recs.append(SimRecord(t, last_acc, rnd, int(sel.size), version))
            if self.ckpt and rnd % self.ckpt_every == 0:
                self._save_state("scen_sync", rnd, t, last_acc, params,
                                 version)
            if t >= max_time:
                break
        return SimResult(recs, params)

    # -- asynchronous ------------------------------------------------------
    def run_async(self, max_merges: int, *, max_time: float = np.inf,
                  resume: bool = False) -> SimResult:
        c = self.cfg
        skip_crash = -1
        if resume and self.ckpt is not None and \
                self.ckpt.latest_step() is not None:
            st = self._restore_state("scen_async")
            params, t, merges = st["params"], st["t"], st["merges"]
            version, last_acc = st["version"], st["last_acc"]
            heap, seq = st["heap"], st["seq"]
            member_queue, base_version = st["members"], st["base_version"]
            recs: list[SimRecord] = []
            if c.server_crash_round > merges:
                skip_crash = c.server_crash_round
        else:
            params = self._init_params()
            t, merges, version = 0.0, 0, 0
            last_acc = self._eval(params)
            recs = [SimRecord(0.0, last_acc, 0, 0, 0)]
            sel = self._select()
            if sel.size == 0:
                return SimResult(recs, params)
            finish = t + self.t_one[sel] * c.epochs + self.t_tx[sel]
            heap = [(float(f), i, int(w)) for i, (f, w) in
                    enumerate(zip(finish, sel))]
            heapq.heapify(heap)
            seq = len(heap)
            # quality: a trained generation of cohort members, folded one
            # per merge with staleness-decayed alpha (the events.py async
            # semantics at population scale)
            member_queue = []
            base_version = 0

        def refill(rnd: int):
            # reads `params` and `version` as they stand at the call: each
            # generation trains from the current server model
            nonlocal member_queue, base_version
            alive_idx = np.flatnonzero(self.alive)
            if alive_idx.size == 0:
                return
            cohort = np.sort(self.rng.choice(
                alive_idx, min(c.cohort_size, alive_idx.size), replace=False))
            stacked, cohort = self._train_members(params, cohort, rnd)
            if stacked is None:
                member_queue = []
                return
            member_queue = [federated.island_slice(stacked, i)
                            for i in range(len(cohort))]
            base_version = version

        while merges < max_merges and t < max_time and heap:
            t_fin, _, wid = heapq.heappop(heap)
            t = max(t, t_fin)
            if not member_queue:
                self._churn()
                refill(merges)
                if not member_queue:
                    t += c.idle_tick
                    continue
            w_params = member_queue.pop(0)
            alpha = aggregation.staleness_alpha(
                c.async_base_alpha, version - base_version,
                scheme=c.staleness_scheme)
            params = aggregation.async_merge(params, w_params, alpha,
                                             impl=self.impl)
            version += 1
            merges += 1
            if self._crashes(merges, skip_crash):
                return SimResult(recs, params, crashed=True)
            last_acc = self._eval(params)
            recs.append(SimRecord(t, last_acc, merges, 1, version))
            if self.alive[wid]:
                heapq.heappush(
                    heap, (t + float(self.t_one[wid] * c.epochs
                                     + self.t_tx[wid]), seq, wid))
                seq += 1
            if self.ckpt and merges % self.ckpt_every == 0:
                self._save_state("scen_async", merges, t, last_acc, params,
                                 version, heap=heap, members=member_queue,
                                 base_version=base_version, seq=seq,
                                 merges=merges)
        return SimResult(recs, params)

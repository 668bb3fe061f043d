"""Discrete-event FL engine (Tier A -- reproduces the paper's experiments),
port of `repro.core.events`.

Simulated WALL-CLOCK comes from each worker's ground-truth profile (speed
factor, contention, bandwidth) while MODEL QUALITY comes from real PyTorch
training on the worker's private shard -- the paper's setup, with the VM
fleet replaced by a seeded event queue.

Sync:  server selects -> all selected train r epochs -> barrier at the
       slowest finish -> weighted aggregate -> evaluate -> policy update.
Async: server folds each response the moment it arrives (staleness-weighted
       alpha), re-dispatches the worker on the NEW version, and late
       responses are still folded -- never dropped (paper SSIII-C.4 case 3).

Both random streams are the reference's, draw for draw: the numpy timing
stream, so `SimRecord.time` and `.round` follow the same draws, and the
jax key, split once per dispatch, whose batch orders `repro_torch.threefry`
computes bit for bit.  Given the reference's initial params, a port run
walks the JAX run's batch orders and differs from it only in float
rounding.

Fault injection (core/faults.py): a `FaultPlan` corrupts worker updates on
the wire (Byzantine attacks), drops / duplicates responses, crash-restarts
workers, and kills the aggregation server mid-round -- every decision the
reference's, draw for draw.  Rejected/diverged updates feed the server's
quarantine counters; async rejections go through the server's bounded
retry/backoff policy.  Checkpointed resume (`ckpt=`) is not ported yet.
"""
from __future__ import annotations

import dataclasses
import heapq

import numpy as np
import torch

from repro_torch import threefry
from repro_torch.core.client import SimWorker, draw_orders
from repro_torch.core.server import AggregationServer
from repro_torch.tree import leaves, tree_map


@dataclasses.dataclass
class SimRecord:
    time: float
    acc: float
    round: int
    n_selected: int
    version: int


@dataclasses.dataclass
class SimResult:
    records: list[SimRecord]
    final_params: object = None
    crashed: bool = False         # server killed mid-round (a FaultPlan)

    def time_to_accuracy(self, target: float) -> float:
        for r in self.records:
            if r.acc >= target:
                return r.time
        return float("inf")

    @property
    def best_acc(self) -> float:
        return max((r.acc for r in self.records), default=0.0)

    def as_arrays(self):
        t = np.array([r.time for r in self.records])
        a = np.array([r.acc for r in self.records])
        return t, a


class FLSimulation:
    def __init__(self, server: AggregationServer, workers: dict[int, SimWorker],
                 test_images, test_labels, *, t_per_sample_ref: float = 2e-3,
                 model_bytes: int = 0, round_overhead: float = 0.5,
                 idle_tick: float = 0.2, time_noise: float = 0.05,
                 seed: int = 0, cohort: bool = True, faults=None,
                 ckpt=None, ckpt_every: int = 1):
        if ckpt is not None:
            raise NotImplementedError("ckpt= needs checkpoint/manager, not "
                                      "ported yet")
        self.server = server
        self.workers = workers
        device = leaves(server.params)[0].device
        self.test_images = torch.as_tensor(test_images, device=device)
        self.test_labels = torch.as_tensor(test_labels, device=device)
        self.t_ref = t_per_sample_ref
        self.model_bytes = model_bytes
        self.round_overhead = round_overhead
        self.idle_tick = idle_tick
        self.noise = time_noise
        self.rng = np.random.default_rng(seed + 17)
        self.key = threefry.key(seed)
        # cohort=True trains same-shape worker groups in one vmapped step
        # (client.LocalTrainer.train_cohort) instead of a Python loop.
        self.cohort = cohort
        self.faults = faults          # Optional faults.FaultPlan
        self.ckpt_every = max(int(ckpt_every), 1)
        trainer = next(iter(workers.values())).trainer
        self._eval = lambda p: trainer.evaluate(p, self.test_images,
                                                self.test_labels)

    # -- timing helpers ------------------------------------------------
    def _noisy(self, t: float) -> float:
        return float(t * self.rng.lognormal(0.0, self.noise))

    def _duration(self, w: SimWorker, epochs: int) -> tuple[float, float, float]:
        t_one = self._noisy(w.profile.true_t_one(self.t_ref))
        t_tx = self._noisy(w.profile.true_t_transmit(self.model_bytes))
        return t_one * epochs + t_tx, t_one, t_tx

    def _next_order(self, w: SimWorker, epochs: int) -> torch.Tensor:
        self.key, k = threefry.split(self.key)
        return draw_orders(k, int(w.images.shape[0]), int(epochs))

    # -- cohort training ----------------------------------------------
    def _train_plan(self, params, plan: list[tuple[int, int, object]]
                    ) -> tuple[dict[int, object], list[int]]:
        """Execute [(wid, epochs, order), ...] -> ({wid: new_params},
        diverged_wids).

        Workers whose shards share a shape (and epoch count and trainer)
        train as ONE vmapped cohort step; stragglers of odd shape take the
        sequential path.  Orders were drawn per worker in plan order, so
        grouping does not perturb the draw stream.  Workers whose local
        step went non-finite are guarded out and reported instead of
        shipping poison."""
        groups: dict[tuple, list[tuple[int, object]]] = {}
        for wid, epochs, order in plan:
            w = self.workers[wid]
            gk = (id(w.trainer), tuple(w.images.shape), epochs)
            groups.setdefault(gk, []).append((wid, order))
        out: dict[int, object] = {}
        diverged: list[int] = []
        device = leaves(params)[0].device
        for (_, shape, epochs), members in groups.items():
            if self.cohort and len(members) > 1 and shape[0] > 0:
                ws = [self.workers[m] for m, _ in members]
                images = torch.stack([torch.as_tensor(w.images, device=device)
                                      for w in ws])
                labels = torch.stack([torch.as_tensor(w.labels, device=device)
                                      for w in ws])
                orders = torch.stack([torch.as_tensor(o) for _, o in members])
                stacked, oks = ws[0].trainer.train_cohort_checked(
                    params, images, labels, orders, epochs)
                for i, (m, _) in enumerate(members):
                    if oks[i]:
                        out[m] = tree_map(lambda x, i=i: x[i], stacked)
                    else:
                        diverged.append(m)
            else:
                for m, order in members:
                    p = self.workers[m].local_train(params, order, epochs)
                    if self.workers[m].diverged:
                        diverged.append(m)
                    else:
                        out[m] = p
        return out, diverged

    def _inject_sync(self, responses: dict[int, object], base, rnd: int
                     ) -> dict[int, object]:
        """Apply the fault plan to one sync round's responses: Byzantine
        corruption relative to the dispatch base, then drops / worker
        crashes (the sync barrier dedupes duplicates by construction)."""
        if self.faults is None:
            return responses
        out = {}
        for wid, p in responses.items():
            if self.faults.response_fate(wid, rnd) == "drop":
                continue
            out[wid] = self.faults.corrupt(p, base, wid, rnd)
        return out

    # -- synchronous ---------------------------------------------------
    def run_sync(self, rounds: int, *, max_time: float = np.inf,
                 target_acc: float = np.inf) -> SimResult:
        srv = self.server
        t = 0.0
        last_acc = self._eval(srv.params)
        recs = [SimRecord(0.0, last_acc, 0, 0, 0)]
        for rnd in range(1, rounds + 1):
            sel = srv.select()
            if not sel:
                t += self.idle_tick
                recs.append(SimRecord(t, last_acc, rnd, 0, srv.version))
                srv.record_accuracy(last_acc)
                continue
            finish = 0.0
            budget = max(
                srv.stats[w].t_one * srv.epochs_for(w) + srv.stats[w].t_transmit
                for w in sel)
            plan = []
            for wid in sel:
                w = self.workers[wid]
                epochs = srv.epochs_for(wid, budget)
                dur, t_one, t_tx = self._duration(w, epochs)
                plan.append((wid, epochs, self._next_order(w, epochs)))
                srv.stats[wid].observe(t_one, t_tx)
                finish = max(finish, dur)
            responses, diverged = self._train_plan(srv.params, plan)
            for wid in diverged:
                srv.note_divergence(wid)
            responses = self._inject_sync(responses, srv.params, rnd)
            t += finish + self.round_overhead
            srv.sync_aggregate(responses, t)
            if self.faults is not None and self.faults.server_crashes(rnd):
                # killed mid-round: the round's work is lost (no record)
                return SimResult(recs, srv.params, crashed=True)
            acc = self._eval(srv.params)
            last_acc = acc
            recs.append(SimRecord(t, acc, rnd, len(sel), srv.version))
            srv.record_accuracy(acc)
            if acc >= target_acc or t >= max_time:
                break
        return SimResult(recs, srv.params)

    # -- asynchronous ----------------------------------------------------
    def run_async(self, max_merges: int, *, max_time: float = np.inf,
                  target_acc: float = np.inf) -> SimResult:
        srv = self.server
        heap: list = []
        rejects: dict[int, int] = {}
        t, merges, seq = 0.0, 0, 0
        last_acc = self._eval(srv.params)
        recs = [SimRecord(0.0, last_acc, 0, 0, 0)]
        in_flight: set[int] = set()

        def dispatch(wid: int, now: float, delay: float = 0.0):
            nonlocal seq
            w = self.workers[wid]
            epochs = srv.epochs_for(wid)
            dur, t_one, t_tx = self._duration(w, epochs)
            new_params = w.local_train(srv.params,
                                       self._next_order(w, epochs), epochs)
            if w.diverged:
                srv.note_divergence(wid)
                return
            if self.faults is not None:
                # Byzantine corruption rides the wire; keyed by the unique
                # dispatch seq so replays inject identically
                new_params = self.faults.corrupt(new_params, srv.params,
                                                 wid, seq)
            srv.stats[wid].observe(t_one, t_tx)
            # the heap orders on (t_fin, seq): seq is unique, so params
            # are never compared; the last field marks a re-delivery
            heapq.heappush(heap, (now + delay + dur, seq, wid, new_params,
                                  srv.version, False))
            seq += 1
            in_flight.add(wid)

        for wid in srv.select():
            dispatch(wid, t)

        while merges < max_merges and t < max_time:
            if not heap:  # nobody selected yet (alg-2 cold start, T=0)
                t += self.idle_tick
                srv.record_accuracy(last_acc)
                recs.append(SimRecord(t, last_acc, merges, 0, srv.version))
                for wid in srv.select():
                    if wid not in in_flight:
                        dispatch(wid, t)
                continue
            t_fin, sq, wid, w_params, base_version, is_dup = \
                heapq.heappop(heap)
            in_flight.discard(wid)
            t = max(t, t_fin)
            if self.faults is not None and not is_dup:
                fate = self.faults.response_fate(wid, sq)
                if fate == "drop":
                    for w2 in srv.select():
                        if w2 not in in_flight:
                            dispatch(w2, t)
                    continue
                if fate == "duplicate":
                    # the network re-delivers the same message a beat later
                    heapq.heappush(heap, (t + self.idle_tick, seq, wid,
                                          w_params, base_version, True))
                    seq += 1
            accepted = srv.async_fold(wid, w_params, base_version, t)
            if not accepted:
                # bounded retry with exponential backoff (server policy)
                rejects[wid] = rejects.get(wid, 0) + 1
                delay = srv.retry_policy(wid, rejects[wid])
                if delay is not None and wid not in in_flight:
                    dispatch(wid, t, delay=delay)
                for w2 in srv.select():
                    if w2 not in in_flight:
                        dispatch(w2, t)
                continue
            merges += 1
            if self.faults is not None and self.faults.server_crashes(merges):
                return SimResult(recs, srv.params, crashed=True)
            acc = self._eval(srv.params)
            last_acc = acc
            recs.append(SimRecord(t, acc, merges, 1, srv.version))
            srv.record_accuracy(acc)
            if acc >= target_acc:
                break
            for w2 in srv.select():
                if w2 not in in_flight:
                    dispatch(w2, t)
        return SimResult(recs, srv.params)

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
retry/backoff policy.

Crash-safe resume: with a `checkpoint.CheckpointManager` attached
(`ckpt=`), the FULL simulation state (server model + control plane, the
numpy stream and the Threefry key, sim clock, and for async the in-flight
response heap including trained params) is checkpointed at round
granularity, in the reference's format.  A killed run resumed from the
latest checkpoint (`resume=True`) replays the interrupted round and
produces a SimRecord stream bit-identical to an uninterrupted run.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Optional

import numpy as np
import torch

from repro_torch import threefry
from repro_torch.checkpoint.manager import load_pytree
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
    crashed: bool = False         # server killed mid-round (resume to finish)

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
        self.ckpt = ckpt              # Optional checkpoint.CheckpointManager
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

    # -- crash-safe state ---------------------------------------------
    def _save_state(self, kind: str, step: int, t: float, last_acc: float,
                    *, heap=(), seq: int = 0, merges: int = 0,
                    rejects: Optional[dict] = None):
        if self.ckpt is None:
            return
        srv = self.server
        state = {"key": self.key}
        if srv._sopt_state.momentum is not None:
            state["sopt_m"] = srv._sopt_state.momentum
        if srv._sopt_state.variance is not None:
            state["sopt_v"] = srv._sopt_state.variance
        heap_meta = []
        for i, (t_fin, s, wid, params, base_version, dup) in \
                enumerate(sorted(heap)):
            state[f"h{i}"] = params
            heap_meta.append({"t_fin": t_fin, "seq": s, "wid": wid,
                              "base_version": base_version, "dup": dup})
        extra = {"kind": kind, "step": int(step), "t": float(t),
                 "last_acc": float(last_acc),
                 "rng_state": self.rng.bit_generator.state,
                 "server": srv.state_dict(),
                 "heap_meta": heap_meta, "seq": int(seq),
                 "merges": int(merges),
                 "rejects": {str(k): int(v)
                             for k, v in (rejects or {}).items()}}
        self.ckpt.save(step, params=srv.params, opt_state=state, extra=extra)

    def _restore_state(self, kind: str) -> dict:
        """Load the latest checkpoint into the server and the streams; the
        restored tensors take the server params' device and dtypes."""
        srv = self.server
        device = leaves(srv.params)[0].device
        step, params, _, extra = self.ckpt.restore(params_like=srv.params,
                                                   device=device)
        if extra.get("kind") != kind:
            raise ValueError(f"checkpoint at step {step} is a "
                             f"'{extra.get('kind')}' run, not '{kind}'")
        srv.params = params
        srv.load_state_dict(extra["server"])
        like = {"key": self.key}
        if srv._sopt_state.momentum is not None:
            like["sopt_m"] = srv._sopt_state.momentum
        if srv._sopt_state.variance is not None:
            like["sopt_v"] = srv._sopt_state.variance
        for i in range(len(extra["heap_meta"])):
            like[f"h{i}"] = srv.params
        state = load_pytree(self.ckpt.path_for(step) / "opt_state.npz", like,
                            device=device)
        self.key = state["key"]
        if "sopt_m" in like:
            srv._sopt_state = dataclasses.replace(
                srv._sopt_state, momentum=state["sopt_m"])
        if "sopt_v" in like:
            srv._sopt_state = dataclasses.replace(
                srv._sopt_state, variance=state["sopt_v"])
        self.rng.bit_generator.state = extra["rng_state"]
        heap = [(float(m["t_fin"]), int(m["seq"]), int(m["wid"]),
                 state[f"h{i}"], int(m["base_version"]), bool(m["dup"]))
                for i, m in enumerate(extra["heap_meta"])]
        heapq.heapify(heap)
        return {"step": step, "t": float(extra["t"]),
                "last_acc": float(extra["last_acc"]), "heap": heap,
                "seq": int(extra["seq"]), "merges": int(extra["merges"]),
                "rejects": {int(k): int(v)
                            for k, v in extra.get("rejects", {}).items()}}

    def _resumable(self, resume: bool) -> bool:
        return resume and self.ckpt is not None and \
            self.ckpt.latest_step() is not None

    def _skip_crash_after(self, resumed_past: int) -> Optional[int]:
        """The crash that killed the run we are resuming must not re-fire
        when its round is replayed; later crash rounds still do."""
        if self.faults is None:
            return None
        pending = [int(r) for r in self.faults.cfg.server_crash_rounds
                   if int(r) > resumed_past]
        return min(pending, default=None)

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
                 target_acc: float = np.inf, resume: bool = False
                 ) -> SimResult:
        srv = self.server
        skip_crash = None
        if self._resumable(resume):
            st = self._restore_state("sync")
            t, start, last_acc = st["t"], st["step"], st["last_acc"]
            recs: list[SimRecord] = []
            skip_crash = self._skip_crash_after(start)
        else:
            t, start = 0.0, 0
            last_acc = self._eval(srv.params)
            recs = [SimRecord(0.0, last_acc, 0, 0, 0)]
        for rnd in range(start + 1, rounds + 1):
            sel = srv.select()
            if not sel:
                t += self.idle_tick
                recs.append(SimRecord(t, last_acc, rnd, 0, srv.version))
                srv.record_accuracy(last_acc)
                if self.ckpt and rnd % self.ckpt_every == 0:
                    self._save_state("sync", rnd, t, last_acc)
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
            if self.faults is not None and self.faults.server_crashes(rnd) \
                    and rnd != skip_crash:
                # killed mid-round: the round's work is lost (no record, no
                # checkpoint); resume replays it from the last checkpoint
                return SimResult(recs, srv.params, crashed=True)
            acc = self._eval(srv.params)
            last_acc = acc
            recs.append(SimRecord(t, acc, rnd, len(sel), srv.version))
            srv.record_accuracy(acc)
            if self.ckpt and rnd % self.ckpt_every == 0:
                self._save_state("sync", rnd, t, acc)
            if acc >= target_acc or t >= max_time:
                break
        return SimResult(recs, srv.params)

    # -- asynchronous ----------------------------------------------------
    def run_async(self, max_merges: int, *, max_time: float = np.inf,
                  target_acc: float = np.inf, resume: bool = False
                  ) -> SimResult:
        srv = self.server
        heap: list = []
        rejects: dict[int, int] = {}
        skip_crash = None
        restored = self._resumable(resume)
        if restored:
            st = self._restore_state("async")
            t, merges, last_acc = st["t"], st["merges"], st["last_acc"]
            heap, seq, rejects = st["heap"], st["seq"], st["rejects"]
            recs: list[SimRecord] = []
            skip_crash = self._skip_crash_after(merges)
        else:
            t, merges, seq = 0.0, 0, 0
            last_acc = self._eval(srv.params)
            recs = [SimRecord(0.0, last_acc, 0, 0, 0)]
        # a duplicate re-delivery is not an outstanding dispatch: the live
        # run never marks it in-flight, so the rebuilt set must not either
        in_flight: set[int] = {e[2] for e in heap if not e[5]}

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

        # a restored run's dispatches are in its heap already
        if not restored:
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
            if self.faults is not None and \
                    self.faults.server_crashes(merges) and \
                    merges != skip_crash:
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
            # checkpoint AFTER the re-dispatch: the saved heap must contain
            # the responses this merge put in flight, or a resumed run
            # would never see them
            if self.ckpt and merges % self.ckpt_every == 0:
                self._save_state("async", merges, t, acc, heap=heap,
                                 seq=seq, merges=merges, rejects=rejects)
        return SimResult(recs, srv.params)

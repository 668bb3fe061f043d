"""Seeded open-loop load generator + trace replay for the serve loops, a
copy of the framework-free `repro.launch.loadgen` (the same numpy
streams: a trace drawn from a seed equals the reference's,
tests/test_torch_loadgen.py).

OPEN-LOOP: arrivals are drawn once from a Poisson process at a target
QPS and never react to the server (no closed-loop back-pressure), so a
slow server shows up as queueing delay in the latency percentiles
instead of silently throttling offered load.  Prompt lengths are
lognormal (most requests short, a heavy tail), output lengths geometric,
and a configurable fraction of requests draw one of ``n_prefixes``
common prompt prefixes -- the workload shape that makes block-table
prefix sharing (core/paging.py) pay off.

Everything is a pure function of ``LoadConfig``: two ``generate()``
calls with the same seed produce identical arrival times, prompts and
output budgets, and ``run_trace(..., tick_s=...)`` drives a loop on a
deterministic VIRTUAL clock (SimRecord-style, like core/scenarios.py)
so a whole load test replays bit-identically.  Pass ``tick_s=None`` for
the wall-clock mode the latency benchmark uses
(the port's examples/serve_load.py).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np


@dataclasses.dataclass(frozen=True)
class LoadConfig:
    qps: float = 8.0
    duration_s: float = 4.0          # arrival horizon (open loop)
    seed: int = 0
    vocab_size: int = 499
    prompt_mean: int = 24            # lognormal median, clipped to bounds
    prompt_sigma: float = 0.6
    prompt_min: int = 4
    prompt_max: int = 96
    out_mean: int = 8                # geometric mean, clipped to bounds
    out_min: int = 2
    out_max: int = 32
    shared_prefix_frac: float = 0.0  # fraction drawing a common prefix
    shared_prefix_len: int = 16
    n_prefixes: int = 2


@dataclasses.dataclass(frozen=True)
class Arrival:
    rid: int
    t: float                         # seconds since trace start
    prompt: np.ndarray               # (T,) int32
    max_new: int


@dataclasses.dataclass(frozen=True)
class ServedRecord:
    rid: int
    t_arrive: float
    t_first: float                   # first output token visible
    t_done: float
    n_prompt: int
    out: tuple                       # generated token ids

    @property
    def latency(self) -> float:
        return self.t_done - self.t_arrive

    @property
    def ttft(self) -> float:
        return self.t_first - self.t_arrive


def generate(cfg: LoadConfig) -> list[Arrival]:
    """Draw the full open-loop trace; deterministic in cfg (incl. seed)."""
    rng = np.random.default_rng(cfg.seed)
    prefixes = [rng.integers(0, cfg.vocab_size, cfg.shared_prefix_len)
                .astype(np.int32) for _ in range(cfg.n_prefixes)]
    arrivals = []
    t = 0.0
    rid = 0
    while True:
        t += rng.exponential(1.0 / cfg.qps)
        if t >= cfg.duration_s:
            break
        n = int(np.clip(round(np.exp(rng.normal(np.log(cfg.prompt_mean),
                                                cfg.prompt_sigma))),
                        cfg.prompt_min, cfg.prompt_max))
        prompt = rng.integers(0, cfg.vocab_size, n).astype(np.int32)
        if cfg.shared_prefix_frac and rng.random() < cfg.shared_prefix_frac:
            pre = prefixes[int(rng.integers(cfg.n_prefixes))]
            tail = max(n - len(pre), 1)
            prompt = np.concatenate([pre, prompt[:tail]])
        m = int(np.clip(rng.geometric(1.0 / cfg.out_mean),
                        cfg.out_min, cfg.out_max))
        arrivals.append(Arrival(rid=rid, t=float(t), prompt=prompt,
                                max_new=m))
        rid += 1
    return arrivals


def run_trace(loop, arrivals: list[Arrival], *, tick_s: float | None = None,
              max_ticks: int = 100_000) -> list[ServedRecord]:
    """Drive a serve loop through an arrival trace.

    tick_s=None  -> WALL clock: request timestamps come from
                    time.monotonic(); this is what the benchmark measures.
    tick_s=float -> VIRTUAL clock: every tick advances exactly tick_s
                    seconds, making the whole run (timestamps included) a
                    deterministic function of (loop params, trace).
    """
    from repro_torch.launch.serve_loop import Request

    pending = sorted(arrivals, key=lambda a: a.t)
    reqs: dict[int, Request] = {}
    arrive_t = {a.rid: a.t for a in arrivals}
    first_t: dict[int, float] = {}
    records: list[ServedRecord] = []
    t0 = time.monotonic()
    tick = 0
    while len(records) < len(arrivals):
        assert tick < max_ticks, "trace did not drain"
        now = tick * tick_s if tick_s is not None else time.monotonic() - t0
        while pending and pending[0].t <= now:
            a = pending.pop(0)
            reqs[a.rid] = Request(rid=a.rid, prompt=a.prompt,
                                  max_new=a.max_new)
            loop.submit(reqs[a.rid])
        if not loop.queue and not loop.live and pending:
            # idle until the next arrival
            if tick_s is None:
                time.sleep(min(pending[0].t - now, 0.01))
            tick += 1
            continue
        finished = loop.tick()
        tick += 1
        end = tick * tick_s if tick_s is not None else time.monotonic() - t0
        for rid, r in reqs.items():
            if rid not in first_t and r.out:
                first_t[rid] = end
        for r in finished:
            records.append(ServedRecord(
                rid=r.rid, t_arrive=arrive_t[r.rid],
                t_first=first_t[r.rid], t_done=end,
                n_prompt=len(r.prompt), out=tuple(r.out)))
    return sorted(records, key=lambda r: r.rid)


def summarize(records: list[ServedRecord], wall_s: float) -> dict:
    """p50/p99 request latency + time-to-first-token and tokens/s."""
    lat = np.array([r.latency for r in records])
    ttft = np.array([r.ttft for r in records])
    n_tokens = int(sum(len(r.out) for r in records))
    return {
        "n_requests": len(records),
        "p50_ms": round(float(np.percentile(lat, 50)) * 1e3, 2),
        "p99_ms": round(float(np.percentile(lat, 99)) * 1e3, 2),
        "ttft_p50_ms": round(float(np.percentile(ttft, 50)) * 1e3, 2),
        "ttft_p99_ms": round(float(np.percentile(ttft, 99)) * 1e3, 2),
        "tokens_out": n_tokens,
        "tokens_per_s": round(n_tokens / max(wall_s, 1e-9), 2),
        "wall_s": round(wall_s, 3),
    }

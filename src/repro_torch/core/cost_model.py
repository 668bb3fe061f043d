"""System-parameter cost model (paper SSIII-D.3, Eq. 4).

The aggregation server estimates each worker's per-epoch training time from
profiled system parameters (the FogBus2 Profiler analogue):

    T_one_w = (T_onedata / CPU_s^freq) * CPU_w^freq_ratio * CPU_w^prop * N_w

where T_onedata is a server-side calibration (time to train ONE sample),
CPU ratios translate it to the worker's clock, CPU_prop accounts for
availability (contention), and N_w is the worker's sample count.  Transmit
time is estimated from a randomly-sized probe transfer (paper SSIII-D.3) --
here: model_bytes / bandwidth + latency.

Once a worker actually participates, ESTIMATES are replaced by measured
values via an EWMA (this is also the straggler detector for Tier B).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class WorkerProfile:
    """Ground-truth system parameters of one (simulated) worker."""
    wid: int
    cpu_freq: float = 2.4e9        # Hz
    cpu_prop: float = 1.0          # available fraction (>=, contention <1)
    bandwidth: float = 100e6 / 8   # bytes/s (100 Mbit)
    latency: float = 0.05          # s per message
    n_data: int = 0                # samples held locally
    speed_factor: float = 1.0      # true slowdown vs the reference machine

    def true_t_one(self, t_per_sample_ref: float) -> float:
        """True wall-clock for one local epoch over all local data."""
        return (t_per_sample_ref * self.speed_factor / max(self.cpu_prop, 1e-3)
                * self.n_data)

    def true_t_transmit(self, model_bytes: int) -> float:
        return 2.0 * (model_bytes / self.bandwidth) + self.latency


@dataclasses.dataclass
class WorkerStats:
    """The server's VIEW of a worker (estimates -> measurements)."""
    wid: int
    t_one: float                   # est. seconds / epoch (all local data)
    t_transmit: float              # est. seconds to exchange weights
    n_data: int
    last_contribution: float = 0.0  # sim-time of last accepted response
    rounds_participated: int = 0
    ewma_beta: float = 0.5

    def observe(self, t_one_measured: float, t_transmit_measured: float):
        b = self.ewma_beta
        self.t_one = (1 - b) * self.t_one + b * t_one_measured
        self.t_transmit = (1 - b) * self.t_transmit + b * t_transmit_measured
        self.rounds_participated += 1


def estimate_t_one(profile: WorkerProfile, *, t_onedata_server: float,
                   server_freq: float) -> float:
    """Eq. 4 -- the server never sees `speed_factor`; it extrapolates from
    its own calibration and the worker's advertised CPU stats."""
    per_sample = (t_onedata_server / server_freq) * profile.cpu_freq
    return per_sample / max(profile.cpu_prop, 1e-3) * profile.n_data


def estimate_t_transmit(profile: WorkerProfile, model_bytes: int) -> float:
    return 2.0 * (model_bytes / profile.bandwidth) + profile.latency


def make_stats(profile: WorkerProfile, *, t_onedata_server: float,
               server_freq: float, model_bytes: int) -> WorkerStats:
    return WorkerStats(
        wid=profile.wid,
        t_one=estimate_t_one(profile, t_onedata_server=t_onedata_server,
                             server_freq=server_freq),
        t_transmit=estimate_t_transmit(profile, model_bytes),
        n_data=profile.n_data,
    )


def heterogeneous_profiles(n_workers: int, n_data: list[int], *, seed: int = 0,
                           speed_spread: float = 4.0) -> list[WorkerProfile]:
    """Worker fleet with speeds spread uniformly in [1, speed_spread] and
    mildly varied network, mirroring the paper's VM heterogeneity."""
    rng = np.random.default_rng(seed)
    profiles = []
    for i in range(n_workers):
        speed = float(rng.uniform(1.0, speed_spread))
        profiles.append(WorkerProfile(
            wid=i,
            cpu_freq=rng.uniform(1.8e9, 3.2e9),
            cpu_prop=float(rng.uniform(0.6, 1.0)),
            bandwidth=float(rng.uniform(25e6, 200e6)) / 8,
            latency=float(rng.uniform(0.01, 0.1)),
            n_data=int(n_data[i]),
            speed_factor=speed,
        ))
    return profiles

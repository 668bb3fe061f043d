"""Learning-rate schedules, port of `repro.optim.schedules`: step count (an
int32 tensor) -> lr, an fp32 0-d tensor on the count's device, computed in
fp32 as the reference computes it."""
from __future__ import annotations

import math

import torch


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def constant(lr: float):
    return lambda step: _f32(lr, step)


def linear_warmup(lr: float, warmup: int):
    def fn(step):
        s = step.float()
        return _f32(lr, s) * torch.clamp(s / max(warmup, 1), max=1.0)
    return fn


def cosine_warmup(lr: float, warmup: int, total: int, floor: float = 0.1):
    def fn(step):
        s = step.float()
        warm = torch.clamp(s / max(warmup, 1), max=1.0)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
        return _f32(lr, s) * warm * cos
    return fn

"""Plain PyTorch version of the flash-attention kernel: the oracle the
kernel is held against on the card, and the path for CPU tensors.

A line-for-line counterpart of the reference's `attention_ref`
(src/repro/kernels/flash_attention/ref.py): exact softmax attention with
GQA head grouping, fp32 math, output in the input dtype.
"""
from __future__ import annotations

import math

import torch


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, H, T, D); k/v: (B, Hkv, S, D) -> (B, H, T, D)."""
    B, H, T, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    G = H // Hkv
    qf = q.float().reshape(B, Hkv, G, T, D)
    kf = k.float()
    vf = v.float()
    s = torch.einsum("bhgtd,bhsd->bhgts", qf, kf) / math.sqrt(D)
    qpos = torch.arange(T, device=q.device)[:, None]
    kpos = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((T, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgts,bhsd->bhgtd", p, vf)
    return o.reshape(B, H, T, D).to(q.dtype)

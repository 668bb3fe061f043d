"""Plain PyTorch version of the linrec kernel: the oracle the kernel is
held against on the card, and the path for CPU tensors.

The reference's `linrec_ref` (src/repro/kernels/linrec/ref.py, a
`lax.scan` over time) with a starting state: a loop over T in fp32, one
product and one sum a step, as the kernel computes it.
"""
from __future__ import annotations

import torch


def linrec_ref(a, b, h0=None):
    """a, b: (B, T, D); h0: (B, D) or None (zeros) -> hs (B, T, D) fp32,
    h_t = a_t h_{t-1} + b_t."""
    B, T, D = a.shape
    h = torch.zeros((B, D), dtype=torch.float32, device=a.device) \
        if h0 is None else h0.float()
    out = torch.empty((B, T, D), dtype=torch.float32, device=a.device)
    for t in range(T):
        h = a[:, t].float() * h + b[:, t].float()
        out[:, t] = h
    return out

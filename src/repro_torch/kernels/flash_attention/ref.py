"""Plain PyTorch version of the flash-attention kernels: the oracle the
kernels are held against on the card, and the path for CPU tensors.

`attention_ref` is a line-for-line counterpart of the reference's
`attention_ref` (src/repro/kernels/flash_attention/ref.py): exact softmax
attention with GQA head grouping, fp32 math, output in the input dtype.
`attention_lse_ref` adds each row's log-sum-exp (the training forward's
second output) and `attention_bwd_ref` is the training kernels' backward,
blockwise as they compute it (csrc/flash_attention_train.cu): P recomputed
from the lse, tiles the mask leaves wholly dead skipped, and P and dS
entering their products as hi + lo pairs of bf16 values.
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


def _mask(qpos, kpos, causal: bool, window: int):
    """(len(qpos), len(kpos)) bool: True where the pair is live."""
    mask = torch.ones((qpos.numel(), kpos.numel()), dtype=torch.bool,
                      device=qpos.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window:
        mask &= kpos[None, :] > qpos[:, None] - window
    return mask


def attention_lse_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, H, T, D); k/v: (B, Hkv, S, D) -> (attention_ref's output
    before its rounding to the inputs' dtype, fp32; lse (B, H, T) fp32:
    each row's natural log-sum-exp of its scaled, masked scores)."""
    B, H, T, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    G = H // Hkv
    qf = q.float().reshape(B, Hkv, G, T, D)
    s = torch.einsum("bhgtd,bhsd->bhgts", qf, k.float()) / math.sqrt(D)
    mask = _mask(torch.arange(T, device=q.device),
                 torch.arange(S, device=q.device), causal, window)
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bhgts,bhsd->bhgtd", p, v.float())
    return o.reshape(B, H, T, D), lse.reshape(B, H, T)


def split_bf16(x):
    """x (fp32) = hi + lo, both bf16 values (returned as fp32): x to
    within 2^-17 of itself, each product with a bf16 operand exact."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def attention_bwd_ref(q, k, v, o, lse, do, *, causal: bool = True,
                      window: int = 0, bq: int = 64, bk: int = 64):
    """The gradients of o = attention(q, k, v) for the output gradient
    `do`, from the forward's o and lse, as the training kernels compute
    them.  q, do: (B, H, T, D); k/v: (B, Hkv, T, D); o (B, H, T, D), the
    forward's output before its rounding (the kernels read it as o +
    o_lo); lse: (B, H, T) fp32 -> (dq, dk, dv) in the inputs' dtypes.

    delta = rowsum(do o); then per key tile of
    `bk` keys and each query tile of `bq` rows that the mask leaves live:
    S and dP = do v^T in fp32, P = exp(S - lse), dS = P (dP - delta), and
    dv += P^T do, dk += dS^T q, dq += dS k with P and dS split hi + lo,
    all accumulated in fp32."""
    B, H, T, D = q.shape
    Hkv = k.shape[1]
    G = H // Hkv
    scale = 1.0 / math.sqrt(D)
    qf = q.float().reshape(B, Hkv, G, T, D)
    dof = do.float().reshape(B, Hkv, G, T, D)
    kf, vf = k.float(), v.float()
    delta = (dof * o.float().reshape(B, Hkv, G, T, D)).sum(-1)
    lse = lse.float().reshape(B, Hkv, G, T)
    dq = torch.zeros_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    pos = torch.arange(T, device=q.device)
    for k0 in range(0, T, bk):
        ks = slice(k0, min(k0 + bk, T))
        for q0 in range(0, T, bq):
            qs = slice(q0, min(q0 + bq, T))
            mask = _mask(pos[qs], pos[ks], causal, window)
            if not mask.any():
                continue                       # a dead tile: not visited
            s = torch.einsum("bhgtd,bhsd->bhgts", qf[..., qs, :],
                             kf[:, :, ks]) * scale
            p = torch.where(mask, torch.exp(s - lse[..., qs, None]),
                            torch.zeros_like(s))
            dp = torch.einsum("bhgtd,bhsd->bhgts", dof[..., qs, :],
                              vf[:, :, ks])
            ds = p * (dp - delta[..., qs, None])
            for part in split_bf16(p):
                dv[:, :, ks] += torch.einsum("bhgts,bhgtd->bhsd", part,
                                             dof[..., qs, :])
            for part in split_bf16(ds):
                dk[:, :, ks] += torch.einsum("bhgts,bhgtd->bhsd", part,
                                             qf[..., qs, :])
                dq[..., qs, :] += torch.einsum("bhgts,bhsd->bhgtd", part,
                                               kf[:, :, ks])
    return ((dq * scale).reshape(B, H, T, D).to(q.dtype),
            (dk * scale).to(k.dtype), dv.to(v.dtype))

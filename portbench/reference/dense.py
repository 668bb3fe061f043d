"""Plain float32 reference of a dense decoder-only LM (Llama / Qwen2-style
blocks as `layouts/dense.py` lays out their weights).

x -> RMSNorm -> attention (QKV projections, optional QKV bias, rotary
positions on q and k by the rotate-half convention, causal softmax in
float32, grouped K/V heads shared by H / Hkv query heads, output
projection) -> residual -> RMSNorm -> MLP (SiLU-gated, or plain GELU with
the tanh approximation) -> residual; a final RMSNorm and the output
projection.  Nothing here imports the program.

`lowp=True` is the control: every matrix product takes its inputs
rounded to float8 e4m3 (weights with one scale a tensor, activations one
scale a row), the step below the bfloat16 the configurations state.  The
rounding is straight-through, so a gradient flows as if it were not there
(the saved inputs of each product are the rounded ones)."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


def _fp8(x: torch.Tensor, dim) -> torch.Tensor:
    xd = x.detach()
    amax = xd.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    s = amax / E4M3_MAX
    q = (xd / s).to(torch.float8_e4m3fn).float() * s
    return x + (q - xd)


def mm(a: torch.Tensor, w: torch.Tensor, lowp: bool) -> torch.Tensor:
    """a (..., k) @ w (k, n) in float32."""
    if lowp:
        a = _fp8(a, -1)
        w = _fp8(w, (0, 1))
    return a @ w


def rmsnorm(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope(x, pos, theta):
    """x (B, T, H, D), pos (B, T) -> rotated (angles in float64)."""
    half = x.shape[-1] // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float64,
                                  device=x.device) / half)
    ang = pos.to(torch.float64)[..., None, None] * inv
    cos, sin = torch.cos(ang).float(), torch.sin(ang).float()
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, qchunk: int):
    """Causal; q (B, T, H, D), k / v (B, T, Hkv, D) -> (B, T, H, D)."""
    B, T, H, D = q.shape
    G = H // k.shape[2]
    k = k.repeat_interleave(G, dim=2).transpose(1, 2)     # (B, H, T, D)
    v = v.repeat_interleave(G, dim=2).transpose(1, 2)
    q = q.transpose(1, 2)
    outs = []
    for s in range(0, T, qchunk):
        qs = q[:, :, s:s + qchunk]
        sc = (qs @ k.transpose(-1, -2)) / math.sqrt(D)
        qi = torch.arange(s, s + qs.shape[2], device=q.device)[:, None]
        ki = torch.arange(T, device=q.device)[None, :]
        sc = sc.masked_fill(ki > qi, float("-inf"))
        outs.append(torch.softmax(sc, dim=-1) @ v)
    return torch.cat(outs, dim=2).transpose(1, 2)


def block(x, lp: dict, arch: dict, pos, *, lowp=False, qchunk=1024):
    """One layer; `lp` maps "attn/wq", "ln1/scale", ... to float32."""
    B, T, d = x.shape
    H, Hkv, D = arch["num_heads"], arch["num_kv_heads"], arch["head_dim"]
    eps, theta = arch["rms_norm_eps"], arch["rope_theta"]
    h = rmsnorm(x, lp["ln1/scale"], eps)
    q = mm(h, lp["attn/wq"].reshape(d, H * D), lowp).view(B, T, H, D)
    k = mm(h, lp["attn/wk"].reshape(d, Hkv * D), lowp).view(B, T, Hkv, D)
    v = mm(h, lp["attn/wv"].reshape(d, Hkv * D), lowp).view(B, T, Hkv, D)
    if "attn/bq" in lp:
        q, k, v = q + lp["attn/bq"], k + lp["attn/bk"], v + lp["attn/bv"]
    q, k = rope(q, pos, theta), rope(k, pos, theta)
    o = attention(q, k, v, qchunk).reshape(B, T, H * D)
    x = x + mm(o, lp["attn/wo"].reshape(H * D, d), lowp)
    h = rmsnorm(x, lp["ln2/scale"], eps)
    u = mm(h, lp["mlp/w_up"], lowp)
    if "mlp/w_gate" in lp:
        a = F.silu(mm(h, lp["mlp/w_gate"], lowp)) * u
    else:
        a = F.gelu(u, approximate="tanh")
    return x + mm(a, lp["mlp/w_down"], lowp)


def split(w: dict, arch: dict, dtype=torch.float32):
    """A flat {path: tensor} tree -> (top-level leaves, [layer i's leaves
    {"attn/wq": ...}]), each a fresh tensor of `dtype`."""
    top = {p: t.to(dtype).clone() for p, t in w.items()
           if not p.startswith("layers/")}
    layers = [{p[len("layers/"):]: t[i].to(dtype).clone()
               for p, t in w.items() if p.startswith("layers/")}
              for i in range(arch["num_layers"])]
    return top, layers


def embed(top: dict, tokens):
    return F.embedding(tokens, top["embed/tok"]).float()


def head(top: dict, x, arch: dict, *, lowp=False):
    h = rmsnorm(x, top["final_norm/scale"].float(), arch["rms_norm_eps"])
    un = top.get("embed/unembed")
    un = top["embed/tok"].t() if un is None else un
    return mm(h, un.float(), lowp)


def logits(top: dict, layers: list, tokens, arch: dict, *, lowp=False,
           qchunk=1024):
    """Whole forward, float32 logits (B, T, V) from float32 leaves (a
    training step differentiates through it)."""
    B, T = tokens.shape
    pos = torch.arange(T, device=tokens.device)[None].expand(B, T)
    x = embed(top, tokens)
    for lp in layers:
        x = block(x, lp, arch, pos, lowp=lowp, qchunk=qchunk)
    return head(top, x, arch, lowp=lowp)

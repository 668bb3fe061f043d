"""Plain reference of the federated trainer's first steps: P islands from
one set of weights, each a train step a step on its own rows (the mean
token cross entropy, its float32 gradient, the clip to a global norm and
AdamW), and after every E steps the int8 exchange of deltas (each
island's delta from the last-sync base quantised to int8 with one scale a
last-axis row, dequantised, mixed by the FedAvg matrix and added to the
base).  Parameters are stored in the configuration's bfloat16 and
updated in float32, as the configuration states; all arithmetic is
float32.  Imports nothing of the program.

`variant` plants a fault or the control in the reference's place:
"fp8" (products in float8, `dense.mm`), "half_batch" (the first half of
each step's rows, the mean over those) or "no_exchange"."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def lr_at(hp: dict, c: int) -> float:
    """cosine_warmup(lr, warmup, total, floor 0.1) at step count c."""
    lr, warm, total = hp["lr"], hp["warmup"], hp["total_steps"]
    w = min(c / max(warm, 1), 1.0)
    prog = min(max((c - warm) / max(total - warm, 1), 0.0), 1.0)
    return lr * w * (0.1 + 0.9 * 0.5 * (1 + math.cos(math.pi * prog)))


def _q8_rows(d: torch.Tensor) -> torch.Tensor:
    """Round trip through symmetric int8 with one scale a last-axis row."""
    scale = d.abs().amax(dim=-1, keepdim=True) / 127.0
    q = torch.round(d / scale.clamp(min=1e-12)).clamp(-127, 127)
    return q * scale


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _norms(top, layers) -> dict:
    """{path: float32 norm}, a stacked leaf's layers taken together."""
    out = {p: t.norm().item() for p, t in top.items()}
    for k in layers[0]:
        out["layers/" + k] = math.sqrt(sum(lp[k].norm().item() ** 2
                                           for lp in layers))
    return out


def run(model, arch: dict, w0: dict, rows, hp: dict, *, n_steps: int = 3,
        variant: str = "", rows_per_chunk: int = 2) -> dict:
    """w0: the flat bfloat16 weights; rows[s][i] = (tokens, labels) of
    step s, island i, long tensors on the device.  -> {"loss": [s][i],
    "grad": {path: [i]} (the first step's clipped gradient), "change":
    {path: [i]} (|params after n_steps - w0|)}."""
    torch.backends.cuda.matmul.allow_tf32 = False     # float32 is float32
    torch.backends.cudnn.allow_tf32 = False
    P, E = hp["islands"], hp["local_steps"]
    b1, b2, eps, clip = hp["b1"], hp["b2"], hp["eps"], hp["clip"]
    lowp = variant == "fp8"
    top0, layers0 = model.split(w0, arch)
    isl = []
    for _ in range(P):
        top = {k: v.clone() for k, v in top0.items()}
        layers = [{k: v.clone() for k, v in lp.items()} for lp in layers0]
        flat = list(top.values()) + [t for lp in layers for t in lp.values()]
        isl.append({"top": top, "layers": layers, "flat": flat,
                    "m": [torch.zeros_like(t) for t in flat],
                    "v": [torch.zeros_like(t) for t in flat]})
    base = [t.clone() for t in isl[0]["flat"]]
    out = {"loss": [], "grad": None, "change": None}
    for s in range(n_steps):
        c = s + 1
        losses = []
        for i, st in enumerate(isl):
            x, y = rows[s][i]
            if variant == "half_batch":
                x, y = x[:x.shape[0] // 2], y[:y.shape[0] // 2]
            n_tok = y.numel()
            leaves = [t.requires_grad_() for t in st["flat"]]
            loss = 0.0
            for r in range(0, x.shape[0], rows_per_chunk):
                with torch.enable_grad():
                    lg = model.logits(st["top"], st["layers"],
                                      x[r:r + rows_per_chunk], arch,
                                      lowp=lowp)
                    part = F.cross_entropy(
                        lg.reshape(-1, lg.shape[-1]),
                        y[r:r + rows_per_chunk].reshape(-1),
                        reduction="sum") / n_tok
                    part.backward()       # accumulates into each .grad
                loss += part.item()
                del lg, part
            g = [t.grad for t in leaves]
            for t in leaves:
                t.grad = None
                t.requires_grad_(False)
            norm = math.sqrt(sum(float(a.square().sum()) for a in g))
            scale = min(clip / max(norm, 1e-9), 1.0)
            for a in g:
                a.mul_(scale)
            if s == 0:
                gt = dict(zip(st["top"], g[:len(st["top"])]))
                n_top = len(st["top"])
                keys = list(st["layers"][0])
                gl = [dict(zip(keys, g[n_top + j * len(keys):
                                       n_top + (j + 1) * len(keys)]))
                      for j in range(len(st["layers"]))]
                gn = _norms(gt, gl)
                if out["grad"] is None:
                    out["grad"] = {p: [] for p in gn}
                for p, v in gn.items():
                    out["grad"][p].append(v)
            lr = lr_at(hp, c)
            bc1, bc2 = 1 - b1 ** c, 1 - b2 ** c
            with torch.no_grad():
                for p, gg, m, v in zip(st["flat"], g, st["m"], st["v"]):
                    m.mul_(b1).add_(gg, alpha=1 - b1)
                    v.mul_(b2).addcmul_(gg, gg, value=1 - b2)
                    u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
                    p.copy_(_bf16(p - lr * u))
            del g
            losses.append(loss)
        out["loss"].append(losses)
        if c % E == 0 and variant != "no_exchange":
            with torch.no_grad():
                for j, b in enumerate(base):
                    d = [_q8_rows(st["flat"][j] - b) for st in isl]
                    mixed = _bf16(b + sum(d) / P)    # FedAvg, equal data
                    for st in isl:
                        st["flat"][j].copy_(mixed)
                    b.copy_(mixed)
    change = {}
    for st in isl:
        nt = len(st["top"])
        keys = list(st["layers"][0])
        dt = {p: st["top"][p] - top0[p] for p in st["top"]}
        dl = [{k: st["layers"][j][k] - layers0[j][k] for k in keys}
              for j in range(len(layers0))]
        for p, v in _norms(dt, dl).items():
            change.setdefault(p, []).append(v)
        del dt, dl, nt
    out["change"] = change
    return out

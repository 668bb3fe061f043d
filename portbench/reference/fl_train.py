"""Plain reference of the federated trainer's first steps: P islands from
one set of weights, each a train step a step on its own rows (the loss,
its float32 gradient, the clip to a global norm and AdamW), and after
every E steps the int8 exchange of deltas.  Parameters are stored in the
configuration's bfloat16 and updated in float32, as the configuration
states; all arithmetic is float32.  Imports nothing of the program.

The loss is the mean token cross entropy plus, for each auxiliary term
the family's reference returns, the coefficient the configuration states
(`hp["loss_terms"]`) times that term.  A family with terms gives
`forward(top, layers, tokens, arch, *, lowp) -> (logits, sums)`, `sums`
its statistics summed over the rows' tokens, and `terms(sums, n_tokens,
arch) -> {name: value}`, each term a function of the whole microbatch's
sums (the load-balance product of two batch means is one).  The rows run
in chunks for memory: a first pass without gradients adds up the sums,
the terms and their gradients with respect to the sums are taken from
those, and the second pass back-propagates each chunk's cross entropy
plus those gradients dotted with its own sums, so the value and the
gradient are the whole microbatch's.  A family without terms gives
`logits` alone.

The exchange (`exchange`): each island's delta from the last-sync base
quantised to int8 with one scale a last-axis row, dequantised, mixed by
the FedAvg matrix (equal data) and added to the base.  With `fog_cells`
C > 1 it is two such hops: island i sits in fog cell i mod C, each cell
takes its members' mean, cast to bfloat16; then each cell's delta from
the base goes through int8 again and the cloud mixes the cells by their
shares of the islands.  With `overlap` the round's exchange is merged
one step stale: after the next step each island adds the mixed weights
less the snapshot the exchange started from (`merge`), and the mixed
weights become the base.

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


def exchange(xs: list, b: torch.Tensor, fog_cells: int = 1) -> torch.Tensor:
    """One leaf's exchange: xs the P islands' float32 leaves, b the shared
    last-sync base -> the mixed leaf every island receives."""
    P = len(xs)
    d = [_q8_rows(x - b) for x in xs]
    if fog_cells <= 1:
        return _bf16(b + sum(d) / P)    # FedAvg, equal data
    cells = [range(c, P, fog_cells) for c in range(fog_cells)]
    fog = [_bf16(b + sum(d[i] for i in m) / len(m)) for m in cells]
    d2 = [_q8_rows(f - b) for f in fog]
    return _bf16(b + sum(len(m) / P * e for m, e in zip(cells, d2)))


def merge(p: torch.Tensor, mixed: torch.Tensor,
          snapshot: torch.Tensor) -> torch.Tensor:
    """A one-step-stale exchange landing on an island's current leaf."""
    return _bf16(p + mixed - snapshot)


def _norms(top, layers) -> dict:
    """{path: float32 norm}, a stacked leaf's layers taken together."""
    out = {p: t.norm().item() for p, t in top.items()}
    for k in layers[0]:
        out["layers/" + k] = math.sqrt(sum(lp[k].norm().item() ** 2
                                           for lp in layers))
    return out


def _term_grads(model, st, x, arch, coef: dict, lowp: bool, chunk: int):
    """The whole microbatch's auxiliary loss (a float) and its gradient
    with respect to the family's summed statistics."""
    with torch.no_grad():
        sums = None
        for r in range(0, x.shape[0], chunk):
            _, s = model.forward(st["top"], st["layers"], x[r:r + chunk],
                                 arch, lowp=lowp)
            sums = s if sums is None else {k: sums[k] + s[k] for k in s}
    leaf = {k: v.detach().requires_grad_() for k, v in sums.items()}
    with torch.enable_grad():
        vals = model.terms(leaf, x.numel(), arch)
        if set(vals) != set(coef):
            raise ValueError(f"the family's loss terms {sorted(vals)} are "
                             f"not the configuration's {sorted(coef)}")
        aux = sum(coef[t] * v for t, v in vals.items())
        g = torch.autograd.grad(aux, list(leaf.values()), allow_unused=True)
    return aux.item(), {k: gk for k, gk in zip(leaf, g) if gk is not None}


def _loss_and_grads(model, st, x, y, arch, coef: dict, lowp: bool,
                    chunk: int, accum: int):
    """One island's loss on its rows (a float) and the gradient of every
    leaf, accumulated into its .grad."""
    n_tok = y.numel()
    loss = 0.0
    with_terms = hasattr(model, "terms")
    if coef and not with_terms:
        raise ValueError(f"the configuration states loss terms {sorted(coef)}"
                         " that the family's reference does not return")
    mb = x.shape[0] // accum if with_terms else x.shape[0]
    for m0 in range(0, x.shape[0], mb):
        xm, ym = x[m0:m0 + mb], y[m0:m0 + mb]
        if with_terms:
            aux, dsum = _term_grads(model, st, xm, arch, coef, lowp, chunk)
            loss += aux / accum
        for r in range(0, xm.shape[0], chunk):
            with torch.enable_grad():
                if with_terms:
                    lg, s = model.forward(st["top"], st["layers"],
                                          xm[r:r + chunk], arch, lowp=lowp)
                else:
                    lg = model.logits(st["top"], st["layers"],
                                      xm[r:r + chunk], arch, lowp=lowp)
                part = F.cross_entropy(
                    lg.reshape(-1, lg.shape[-1]),
                    ym[r:r + chunk].reshape(-1), reduction="sum") / n_tok
                total = part
                if with_terms:
                    total = part + sum((dsum[k] * s[k]).sum() / accum
                                       for k in dsum)
                total.backward()          # accumulates into each .grad
            loss += part.item()
            del lg, part, total
    return loss


def run(model, arch: dict, w0: dict, rows, hp: dict, *, n_steps: int = 3,
        variant: str = "", rows_per_chunk: int = 2) -> dict:
    """w0: the flat bfloat16 weights; rows[s][i] = (tokens, labels) of
    step s, island i, long tensors on the device; hp: the optimizer's and
    the job's settings, `loss_terms`, `fog_cells` and `overlap` among
    them.  -> {"loss": [s][i], "grad": {path: [i]} (the first step's
    clipped gradient), "change": {path: [i]} (|params after n_steps -
    w0|)}."""
    torch.backends.cuda.matmul.allow_tf32 = False     # float32 is float32
    torch.backends.cudnn.allow_tf32 = False
    P, E = hp["islands"], hp["local_steps"]
    b1, b2, eps, clip = hp["b1"], hp["b2"], hp["eps"], hp["clip"]
    coef, fog_cells, overlap = hp["loss_terms"], hp["fog_cells"], \
        hp["overlap"]
    accum = arch.get("grad_accum", 1)
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
    pending = None       # (mixed, each island's snapshot), bfloat16
    out = {"loss": [], "grad": None, "change": None}
    for s in range(n_steps):
        c = s + 1
        losses = []
        for i, st in enumerate(isl):
            x, y = rows[s][i]
            if variant == "half_batch":
                x, y = x[:x.shape[0] // 2], y[:y.shape[0] // 2]
            leaves = [t.requires_grad_() for t in st["flat"]]
            loss = _loss_and_grads(model, st, x, y, arch, coef, lowp,
                                   rows_per_chunk, accum)
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
        with torch.no_grad():
            if pending is not None:
                mixed, snaps = pending
                for st, snap in zip(isl, snaps):
                    for p, mx, sn in zip(st["flat"], mixed, snap):
                        p.copy_(merge(p, mx.float(), sn.float()))
                for b, mx in zip(base, mixed):
                    b.copy_(mx)
                pending = None
            if c % E or variant == "no_exchange" or (overlap
                                                    and c == n_steps):
                continue     # (an exchange that would land after the end)
            if overlap:
                pending = ([exchange([st["flat"][j] for st in isl], b,
                                     fog_cells).to(torch.bfloat16)
                            for j, b in enumerate(base)],
                           [[t.to(torch.bfloat16) for t in st["flat"]]
                            for st in isl])
                continue
            for j, b in enumerate(base):
                mixed = exchange([st["flat"][j] for st in isl], b, fog_cells)
                for st in isl:
                    st["flat"][j].copy_(mixed)
                b.copy_(mixed)
    change = {}
    for st in isl:
        keys = list(st["layers"][0])
        dt = {p: st["top"][p] - top0[p] for p in st["top"]}
        dl = [{k: st["layers"][j][k] - layers0[j][k] for k in keys}
              for j in range(len(layers0))]
        for p, v in _norms(dt, dl).items():
            change.setdefault(p, []).append(v)
        del dt, dl
    out["change"] = change
    return out

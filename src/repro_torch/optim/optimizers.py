"""Optimizers on tensor trees, port of `repro.optim.optimizers`.

State mirrors the parameter tree leaf for leaf, with fp32 moments and an
int32 step count whatever the param dtype: {"mu", "nu", "count"} for adamw,
{"mom", "count"} for sgd_momentum, so a checkpoint's optimizer state moves
between the two packages through `CheckpointManager` (and numpy leaves
through `param.from_reference`).  Params stay in their dtype and the update
is computed in fp32, in the reference's order of operations.

Each optimizer has two forms of its update:

  update(grads, state, params) -> (updates, state)
      the reference's, out of place: fp32 updates for the whole tree, for
      `apply_updates`;
  step_(pieces, state, *, grad_scale=None)
      the same arithmetic in place and piece by piece: `pieces` yields
      (param, grad, *moments) tensors of one shape (a leaf, or one layer's
      slice of a stacked leaf: views into the param and state trees,
      `launch/steps.py` builds them), each walked in row chunks of at most
      CHUNK elements, so the fp32 temporaries of a full-width leaf never
      exist whole.  `grad_scale` (an fp32 0-d tensor) is the clip factor,
      applied as `clip_by_global_norm` applies it; the count advances once.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from repro_torch.models.param import ParamDef
from repro_torch.tree import leaves, tree_map

#: row chunk of the in-place update: fp32 temporaries of at most 256 MB
CHUNK = 1 << 26


class Optimizer(NamedTuple):
    init: Callable
    update: Callable          # (grads, state, params) -> (updates, state)
    step_: Callable           # (pieces, state, *, grad_scale) -> None


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of the leaves' fp32 sums of squares (`tree` may also
    be a list of tensors)."""
    ls = tree if isinstance(tree, list) else leaves(tree)
    return torch.sqrt(torch.sum(torch.stack(
        [torch.sum(torch.square(l.float())) for l in ls])))


def clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(tree, max_norm: float):
    norm = global_norm(tree)
    scale = clip_scale(norm, max_norm)
    return tree_map(lambda l: l.float() * scale, tree), norm


def _lr_fn(lr):
    if callable(lr):
        return lr
    return lambda c: torch.tensor(lr, dtype=torch.float32, device=c.device)


def _zeros32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _chunks(*ts):
    """Matching row chunks of same-shape tensors, CHUNK elements at most."""
    n = ts[0].numel()
    if n <= CHUNK or ts[0].dim() == 0:
        yield ts
        return
    rows = ts[0].shape[0]
    step = max(1, CHUNK // max(n // rows, 1))
    for i in range(0, rows, step):
        yield tuple(t[i:i + step] for t in ts)


def _clipped(g: torch.Tensor, grad_scale) -> torch.Tensor:
    g = g.float()
    return g if grad_scale is None else g * grad_scale


def adamw(lr: Callable | float, *, b1=0.9, b2=0.95, eps=1e-8,
          weight_decay=0.0) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        return {"mu": tree_map(_zeros32, params),
                "nu": tree_map(_zeros32, params),
                "count": torch.zeros((), dtype=torch.int32,
                                     device=leaves(params)[0].device)}

    def _scalars(count):
        c = count + 1
        cf = c.float()
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                         device=c.device), cf)
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                         device=c.device), cf)
        return c, lr_fn(c), bc1, bc2

    def _step(m, v, p, lr_t, bc1, bc2):
        step = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        if weight_decay:
            step = step + weight_decay * p.float()
        return -lr_t * step

    def update(grads, state, params):
        c, lr_t, bc1, bc2 = _scalars(state["count"])
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(),
                      state["mu"], grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.float()),
                      state["nu"], grads)
        updates = tree_map(lambda m, v, p: _step(m, v, p, lr_t, bc1, bc2),
                           mu, nu, params)
        return updates, {"mu": mu, "nu": nu, "count": c}

    def step_(pieces, state, *, grad_scale=None):
        c, lr_t, bc1, bc2 = _scalars(state["count"])
        for piece in pieces:
            for p, g, m, v in _chunks(*piece):
                g = _clipped(g, grad_scale)
                m.copy_(b1 * m + (1 - b1) * g)
                v.copy_(b2 * v + (1 - b2) * torch.square(g))
                p.copy_((p.float() + _step(m, v, p, lr_t, bc1, bc2))
                        .to(p.dtype))
        state["count"].copy_(c)

    return Optimizer(init, update, step_)


def sgd_momentum(lr: Callable | float, *, momentum=0.9,
                 nesterov=False) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        return {"mom": tree_map(_zeros32, params),
                "count": torch.zeros((), dtype=torch.int32,
                                     device=leaves(params)[0].device)}

    def _upd(m, g, lr_t):
        if nesterov:
            return -lr_t * (momentum * m + g.float())
        return -lr_t * m

    def update(grads, state, params):
        c = state["count"] + 1
        lr_t = lr_fn(c)
        mom = tree_map(lambda m, g: momentum * m + g.float(),
                       state["mom"], grads)
        upd = tree_map(lambda m, g: _upd(m, g, lr_t), mom, grads)
        return upd, {"mom": mom, "count": c}

    def step_(pieces, state, *, grad_scale=None):
        c = state["count"] + 1
        lr_t = lr_fn(c)
        for piece in pieces:
            for p, g, m in _chunks(*piece):
                g = _clipped(g, grad_scale)
                m.copy_(momentum * m + g)
                p.copy_((p.float() + _upd(m, g, lr_t)).to(p.dtype))
        state["count"].copy_(c)

    return Optimizer(init, update, step_)


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p.float() + u).to(p.dtype), params, updates)


def moment_names(state) -> tuple[str, ...]:
    """The state's moment trees, in the order `step_` takes them."""
    return tuple(k for k in ("mu", "nu", "mom") if k in state)


def opt_state_defs(param_defs, optimizer: str = "adamw"):
    """ParamDef tree of the optimizer state."""
    def f32(d: ParamDef) -> ParamDef:
        return dataclasses.replace(d, dtype=torch.float32, init="zeros")

    moments = {"adamw": ("mu", "nu"), "sgd": ("mom",)}[optimizer]
    out = {name: tree_map(f32, param_defs) for name in moments}
    out["count"] = ParamDef((), torch.int32, (), "zeros")
    return out

"""Parameter definitions: ParamDef trees with torch dtypes.

A model is described by a dict tree of ParamDef leaves (shape + dtype +
logical axes + initializer), keyed exactly like the reference's
(`repro.models.param`), so params move between the two packages leaf for
leaf (`from_reference`).  `init_params` draws from a Threefry key
(`repro_torch.threefry`) as the reference draws from `jax.random.key`, so
one seed gives both packages the same initial params (to a few ulp).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch

from repro_torch import threefry
from repro_torch.tree import leaves, tree_map, unflatten_like


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    dtype: torch.dtype
    logical_axes: tuple
    init: str = "normal"   # "normal" | "zeros" | "ones" | "embed" | "scalar:<v>"
    fan_in_axes: tuple[int, ...] = ()  # dims contributing to fan-in for scaling


def pdef(shape: Sequence[int], axes: Sequence, dtype=torch.bfloat16,
         init: str = "normal", fan_in_axes: Sequence[int] = ()) -> ParamDef:
    return ParamDef(tuple(int(s) for s in shape), dtype, tuple(axes),
                    init, tuple(fan_in_axes))


def init_leaf(key: np.ndarray, d: ParamDef) -> torch.Tensor:
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=d.dtype)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=d.dtype)
    if d.init.startswith("scalar:"):
        return torch.full(d.shape, float(d.init.split(":")[1]), dtype=d.dtype)
    if d.init == "embed":
        scale = 1.0
    else:
        fan_in = 1
        for ax in (d.fan_in_axes or range(max(len(d.shape) - 1, 1))):
            fan_in *= d.shape[ax] if ax < len(d.shape) else 1
        scale = 1.0 / math.sqrt(max(fan_in, 1))
    return torch.from_numpy(threefry.normal(key, d.shape) * scale).to(d.dtype)


def init_params(key: np.ndarray, defs, device="cpu"):
    """One split of `key` per leaf, in the reference's leaf order; drawn on
    the host and then moved, so one key gives the same params on every
    device."""
    flat = leaves(defs)
    keys = threefry.split(key, len(flat))
    return unflatten_like(defs, [init_leaf(k, d).to(device)
                                 for k, d in zip(keys, flat)])


def _leaf_from_reference(a, device) -> torch.Tensor:
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bf16: widening is exact
        return torch.from_numpy(a.astype(np.float32)).to(device,
                                                          torch.bfloat16)
    return torch.from_numpy(a).to(device)


def from_reference(tree, device="cpu"):
    """The JAX package's params (any array-likes, e.g. numpy) -> the port's
    tensors, leaf for leaf; keys and layouts are shared."""
    return tree_map(lambda a: _leaf_from_reference(a, device), tree)


def to_numpy(tree):
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def count_params(defs) -> int:
    return int(sum(int(np.prod(d.shape)) for d in leaves(defs)))

"""Parameter definitions: ParamDef trees with torch dtypes.

From one definition tree come concrete params (`init_params`,
`init_params_on_device`), meta params for the cost walk
(`abstract_params`) and per-device bytes on a mesh (dist/policy.py).

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


def is_def(x) -> bool:
    return isinstance(x, ParamDef)


def pdef(shape: Sequence[int], axes: Sequence, dtype=torch.bfloat16,
         init: str = "normal", fan_in_axes: Sequence[int] = ()) -> ParamDef:
    return ParamDef(tuple(int(s) for s in shape), dtype, tuple(axes),
                    init, tuple(fan_in_axes))


def stack_defs(defs, n: int):
    """Prepend a stacked `layers` axis of size n to every leaf (the layer
    stack the reference scans over and the port indexes)."""
    return tree_map(
        lambda d: ParamDef((n,) + d.shape, d.dtype,
                           ("layers",) + d.logical_axes, d.init,
                           tuple(a + 1 for a in d.fan_in_axes)), defs)


#: top-level keys of the layer stacks, one per family: transformer and
#: ssm, the hybrid's super-blocks, the enc-dec's two stacks
STACKED = ("layers", "super", "enc_layers", "dec_layers")


class LayerSlices(list):
    """A stacked (L, ...) param subtree given as its L per-layer trees, in
    place of the stack.  A train step passes each layer's slice as a leaf
    of its own (views of the stacked storage), so autograd's gradient of a
    slice is that slice's alone, where indexing the stack inside the model
    would add a full-size (L, ...) zero tensor per layer into its grad."""


def layer_params(stack, i: int):
    """Layer i's param tree of a stacked subtree or of its LayerSlices."""
    if isinstance(stack, LayerSlices):
        return stack[i]
    return tree_map(lambda a: a[i], stack)


def _scale(d: ParamDef) -> float:
    if d.init == "embed":
        return 1.0
    fan_in = 1
    for ax in (d.fan_in_axes or range(max(len(d.shape) - 1, 1))):
        fan_in *= d.shape[ax] if ax < len(d.shape) else 1
    return 1.0 / math.sqrt(max(fan_in, 1))


def init_leaf(key: np.ndarray, d: ParamDef) -> torch.Tensor:
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=d.dtype)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=d.dtype)
    if d.init.startswith("scalar:"):
        return torch.full(d.shape, float(d.init.split(":")[1]), dtype=d.dtype)
    return torch.from_numpy(threefry.normal(key, d.shape)
                            * _scale(d)).to(d.dtype)


def init_params(key: np.ndarray, defs, device="cpu"):
    """One split of `key` per leaf, in the reference's leaf order; drawn on
    the host and then moved, so one key gives the same params on every
    device."""
    flat = leaves(defs)
    keys = threefry.split(key, len(flat))
    return unflatten_like(defs, [init_leaf(k, d).to(device)
                                 for k, d in zip(keys, flat)])


def init_params_on_device(seed: int, defs, device, *,
                          chunk_elements: int = 1 << 28):
    """Params for `defs` drawn on `device` by one `torch.Generator(device)`
    seeded with `seed`, leaf after leaf in the reference's leaf order, with
    `init_leaf`'s rules: fp32 normal x 1/sqrt(fan_in), cast to the leaf's
    dtype.  The fp32 draw goes in slices of at most `chunk_elements`
    values along the leading axes (one leading-axis row at a time, or
    rows of the next axis where a row is larger), so a (52, 6144, 24576)
    bf16 stack needs 1 GB of scratch, not 31 GB, and an MoE layer stack
    (8, 8, 6144, 16384), whose rows hold 805 M values, 0.8 GB.

    The numbers are torch's, not Threefry's: these params are not the JAX
    package's for the same seed and are never compared with them (the
    tests move params across with `from_reference`, or draw small models
    with `init_params`)."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = []
    for d in leaves(defs):
        if d.init == "zeros":
            out.append(torch.zeros(d.shape, dtype=d.dtype, device=device))
        elif d.init == "ones":
            out.append(torch.ones(d.shape, dtype=d.dtype, device=device))
        elif d.init.startswith("scalar:"):
            out.append(torch.full(d.shape, float(d.init.split(":")[1]),
                                  dtype=d.dtype, device=device))
        else:
            t = torch.empty(d.shape, dtype=d.dtype, device=device)
            lead = 1 if t.dim() > 1 else 0     # leading axes of a slice row
            while lead < t.dim() - 1 and \
                    math.prod(d.shape[lead:]) > chunk_elements:
                lead += 1
            flat = t.view(math.prod(d.shape[:lead]), -1)
            step = max(1, chunk_elements // max(flat.shape[1], 1))
            for i in range(0, flat.shape[0], step):
                part = flat[i:i + step]
                part.copy_(torch.randn(part.shape, generator=gen,
                                       device=device).mul_(_scale(d)))
            out.append(t)
    return unflatten_like(defs, out)


def _leaf_from_reference(a, device) -> torch.Tensor:
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bf16: widening is exact
        return torch.from_numpy(a.astype(np.float32)).to(device,
                                                          torch.bfloat16)
    return torch.from_numpy(a).to(device)


def from_reference(tree, device="cpu"):
    """The JAX package's params (any array-likes, e.g. numpy) -> the port's
    tensors, leaf for leaf; keys and layouts are shared.  The optimizer
    state crosses the same way ({"mu", "nu", "count"}: fp32 moments, an
    int32 count, as `repro_torch.optim` keeps them)."""
    return tree_map(lambda a: _leaf_from_reference(a, device), tree)


def to_numpy(tree):
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def count_params(defs) -> int:
    return int(sum(int(np.prod(d.shape)) for d in leaves(defs)))


def param_bytes(defs) -> int:
    return int(sum(int(np.prod(d.shape)) * d.dtype.itemsize
                   for d in leaves(defs)))


def abstract_params(defs):
    """Meta tensors of each def's shape and dtype: no memory at any width,
    which is what the cost walk (dist/cost.py) traces a full-width step
    on, as the reference's ShapeDtypeStructs are what it lowers."""
    return tree_map(lambda d: torch.empty(d.shape, dtype=d.dtype,
                                          device="meta"), defs)

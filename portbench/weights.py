"""Weights made from the seed on the device, in the type they are served in.

Every "normal" leaf is a slice of one flat buffer filled by
`torch.Generator(device)` seeded with the run's seed, in calls of
CHUNK values each (a few large calls, not leaf by leaf), then scaled in
place; "ones" and "zeros" leaves are filled.  The same seed, layout and
device give the same bytes, which is how the reference makes them again
after the window without taking anything from the program."""
from __future__ import annotations

import math

import torch

CHUNK = 1 << 30


def make(layout_leaves, seed: int, device, dtype=torch.bfloat16) -> dict:
    """-> nested dict tree {"a": {"b": tensor}} of the layout's leaves."""
    device = torch.device(device)
    normal = [(p, s, sc) for p, s, init, sc in layout_leaves
              if init == "normal"]
    total = sum(math.prod(s) for _, s, _ in normal)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    flat = torch.empty(total, dtype=dtype, device=device)
    for i in range(0, total, CHUNK):
        flat[i:i + CHUNK].normal_(generator=gen)
    out, off = {}, 0
    for path, shape, scale in normal:
        n = math.prod(shape)
        t = flat[off:off + n].view(shape)
        off += n
        if scale != 1.0:
            t.mul_(scale)
        out[path] = t
    for path, shape, init, _ in layout_leaves:
        if init == "ones":
            out[path] = torch.ones(shape, dtype=dtype, device=device)
        elif init == "zeros":
            out[path] = torch.zeros(shape, dtype=dtype, device=device)
        elif init != "normal":
            raise ValueError(f"{path}: unknown init {init!r}")
    return nest(out)


def nest(flat: dict) -> dict:
    tree: dict = {}
    for path, t in flat.items():
        node = tree
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = t
    return tree


def flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k in sorted(tree):
        v = tree[k]
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flatten(v, p))
        else:
            out[p] = v
    return out


def check_against(layout_leaves, program_defs) -> None:
    """The layout's paths and shapes equal the program's param defs."""
    defs = flatten(program_defs)
    ours = {p: tuple(s) for p, s, _, _ in layout_leaves}
    theirs = {p: tuple(d.shape) for p, d in defs.items()}
    if ours != theirs:
        diff = sorted(set(ours.items()) ^ set(theirs.items()))
        raise ValueError(f"weight layout differs from the program's: {diff}")

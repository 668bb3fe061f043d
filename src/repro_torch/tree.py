"""Parameter trees: nested dicts of tensors, walked in sorted-key order
(the leaf order `jax.tree` gives the reference's dict pytrees)."""
from __future__ import annotations


def leaves(tree) -> list:
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in leaves(tree[k])]
    return [tree]


def tree_map(fn, tree, *rest):
    """fn applied leaf-wise over trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def unflatten_like(tree, flat: list):
    """Rebuild `tree`'s structure from leaves in `leaves(tree)` order."""
    it = iter(flat)
    out = tree_map(lambda _: next(it), tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template has")
    return out

"""The numbers that decide `correct`, each compared with its limit
(`limits/<workload>.json`), and how they are printed."""
from __future__ import annotations

import math
import statistics
import sys

#: a leaf whose reference gradient is under this share of the median
#: leaf's moves by round-off alone and is left out of the change
GRAD_FLOOR = 1e-3


def _leaf_gap(prog: dict, ref: dict, keep=None) -> float:
    """The worst leaf's |program norm - reference norm| over the larger
    of the reference's norm of that leaf and of the median leaf, island
    by island."""
    worst = 0.0
    n_isl = len(next(iter(ref.values())))
    for i in range(n_isl):
        med = statistics.median(ref[p][i] for p in ref)
        for p in ref:
            if keep is not None and p not in keep[i]:
                continue
            den = max(ref[p][i], med)
            gap = abs(prog[p][i] - ref[p][i]) / den if den > 0 else \
                abs(prog[p][i])
            if math.isnan(gap):
                return gap
            worst = max(worst, gap)
    return worst


def leaf_gaps(prog: dict, ref: dict) -> dict:
    """{leaf: its worst gap over the islands}, `_leaf_gap`'s terms (what
    calibration prints to find the leaf a reading comes from)."""
    return {p: _leaf_gap(prog, ref, keep=[{p}] * len(ref[p])) for p in ref}


def counted_leaves(ref_grad: dict) -> list[set]:
    n_isl = len(next(iter(ref_grad.values())))
    out = []
    for i in range(n_isl):
        med = statistics.median(ref_grad[p][i] for p in ref_grad)
        out.append({p for p in ref_grad if ref_grad[p][i] >= GRAD_FLOOR * med})
    return out


def train_numbers(prog: dict, ref: dict) -> dict:
    """prog / ref: {"loss": [s][i], "grad": {path: [i]}, "change": {path:
    [i]}} -> {loss, grad, change}: the worst relative loss gap over the
    steps and islands, and the worst leaf of the first clipped gradient
    and of the params' change after the checked steps."""
    loss = max(abs(a - b) / abs(b)
               for pa, ra in zip(prog["loss"], ref["loss"])
               for a, b in zip(pa, ra))
    keep = counted_leaves(ref["grad"])
    return {"loss": loss,
            "grad": _leaf_gap(prog["grad"], ref["grad"]),
            "change": _leaf_gap(prog["change"], ref["change"], keep)}


def decide(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Every number at or under its limit, and finite."""
    checks, ok = {}, True
    for name, lim in limits.items():
        v = numbers.get(name)
        good = v is not None and math.isfinite(v) and v <= lim
        ok &= good
        checks[name] = {"value": v, "limit": lim}
    return ok, checks


def print_checks(checks: dict) -> None:
    """The numbers compared, as the last lines on standard error."""
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr, flush=True)

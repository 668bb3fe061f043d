"""The cost walk, the port's counterpart of `repro.dist.hlo_cost`.

The port has no compiler and no HLO.  Its cost model is a walk of the
aten operations one call of a step really dispatches, under a
`TorchDispatchMode`:

  * flops -- `torch.utils.flop_counter`'s formulas (matmuls,
    convolutions, attention), kept by the dtype of the op's first tensor
    input; elementwise operations count no flops, as there;
  * bytes -- the eager, unfused model: every operation that is not a
    view reads each tensor input once and writes each tensor output once,
    the counterpart of the reference's fusion-boundary model in which
    every op is its own fusion.  A write into part of a tensor in place
    (`index_put_`, `scatter_`, `index_copy_`, ...) is charged for the
    values and indices it moves, not the whole tensor, and a tensor an
    op only overwrites (`copy_`, `fill_`, `zero_`) is written, not read.
    Allocations (`empty*`) and metadata ops cost nothing;
  * collectives -- the outputs of `c10d` operations (none in one
    process: launch/dryrun.py adds the layout's collectives
    analytically).

A Python loop dispatches every trip, so no trip-count multiplier is
needed: an L-layer loop counts L times one layer.  A gradient counts the
forward and the backward ops, which autograd dispatches under the mode.

The walk runs on meta tensors (any width, no memory; `param.
abstract_params`) and on the card, and gives the same totals on both.
The hand-written kernels are not aten ops, so the mode cannot see them:
each kernel's dispatcher (`kernels/*/ops.py`) reports its call through
`kernel_call` with a thunk of its work formula from dist/hardware.py
(called only inside a walk, so a call outside one computes nothing),
and the ops
the dispatcher runs inside (the plain version on the CPU, an output
allocation on the card or on meta) are not counted.  On a meta tensor a
dispatcher returns an empty output of the right shape, so a full-width
step traces without a card.

An op that needs host data (`.item()`, `.tolist()`, a data-dependent
shape) raises on meta: `analyze` returns that as a diagnostic naming the
op, with the totals up to it, never as a silent skip.  On the card such
an op runs and is recorded as a diagnostic too (a host sync).

The reference's functions that parse XLA's text (`ModuleCost`,
`collective_bytes(text)`, `cost_analysis_terms`) have no counterpart.
"""
from __future__ import annotations

import contextlib
import threading

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                        _get_current_dispatch_mode_stack)
from torch.utils.flop_counter import flop_registry

#: allocations and metadata: nothing read or written
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "_unsafe_view", "lift_fresh", "alias",
         "resize_", "set_", "record_stream"}
#: in place writes of a region: the values (and indices) moved
_REGION = {"index_put_", "_index_put_impl_", "scatter_", "scatter_add_",
           "scatter_reduce_", "index_add_", "index_copy_"}
#: in place overwrites of their first argument: written, not read
_OVERWRITE = {"copy_", "fill_", "zero_", "uniform_", "normal_"}
#: ops that read host data (a sync on the card, an error on meta)
_HOST = {"_local_scalar_dense", "item", "nonzero", "_assert_async",
         "masked_select", "unique", "_unique2"}

_state = threading.local()


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _dtype(dtype) -> str:
    return str(dtype).split(".")[-1]


class _Walk(TorchDispatchMode):
    """Totals of one walk (see the module docstring)."""

    def __init__(self):
        super().__init__()
        self.flops_by_dtype: dict[str, float] = {}
        self.hbm_bytes = 0.0
        self.collective_bytes = 0.0
        self.by_op: dict[str, dict] = {}
        self.diagnostics: list[str] = []
        self.kernel_depth = 0

    def add(self, name: str, flops_by_dtype: dict, nbytes: float,
            collective: float = 0.0):
        rec = self.by_op.setdefault(name, {"count": 0, "flops": 0.0,
                                           "bytes": 0.0})
        rec["count"] += 1
        for dt, f in flops_by_dtype.items():
            self.flops_by_dtype[dt] = self.flops_by_dtype.get(dt, 0.0) + f
            rec["flops"] += f
        rec["bytes"] += nbytes
        self.hbm_bytes += nbytes
        self.collective_bytes += collective

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func._schema.name.split("::")[-1]
        try:
            out = func(*args, **kwargs)
        except Exception as e:
            if self.kernel_depth == 0:
                self.diagnostics.append(f"{func}: {type(e).__name__}: {e}")
            raise
        if self.kernel_depth:
            return out
        if name in _HOST:
            self.diagnostics.append(f"{func}: reads host data (a sync)")
        self._count(func, name, args, kwargs, out)
        return out

    def _count(self, func, name, args, kwargs, out):
        if func.is_view or name in _FREE:
            return
        ins = [t for k, v in kwargs.items() if k != "out"
               for t in _tensors(v)]
        ins = list(_tensors(args)) + ins
        outs = list(_tensors(out))
        if name in _REGION:
            moved = list(_tensors(args[1:])) + [
                t for k, v in kwargs.items() for t in _tensors(v)]
            vals = max((_nbytes(t) for t in moved
                        if t.dtype == args[0].dtype), default=0)
            nbytes = sum(_nbytes(t) for t in moved) + vals
        elif name in _OVERWRITE:
            nbytes = sum(_nbytes(t) for t in ins[1:]) + _nbytes(ins[0])
        else:
            nbytes = sum(_nbytes(t) for t in ins) + \
                sum(_nbytes(t) for t in outs)
        flops = {}
        fn = flop_registry.get(func._overloadpacket)
        if fn is not None:
            f = fn(*args, **kwargs, out_val=out)
            if f:
                flops[_dtype(ins[0].dtype)] = float(f)
        coll = 0.0
        if func.namespace in ("_c10d_functional", "c10d"):
            coll = float(sum(_nbytes(t) for t in outs))
        self.add(f"aten.{name}", flops, nbytes, coll)

    def result(self) -> dict:
        return {"flops": float(sum(self.flops_by_dtype.values())),
                "flops_by_dtype": dict(self.flops_by_dtype),
                "hbm_bytes": float(self.hbm_bytes),
                "collective_bytes": float(self.collective_bytes),
                "by_op": {k: dict(v) for k, v in self.by_op.items()},
                "diagnostics": list(self.diagnostics)}


def active():
    """The innermost walk running on this thread, or None.  For CUDA
    tensors autograd runs a backward (and remat's recompute inside it) on
    a thread of its own, which inherits the dispatch modes but not this
    module's thread-local stack: there it is the innermost walk among the
    modes."""
    stack = getattr(_state, "stack", ())
    if stack:
        return stack[-1]
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, _Walk):
            return mode
    return None


@contextlib.contextmanager
def walk():
    """Count every aten op dispatched inside; -> the walk (`.result()`)."""
    w = _Walk()
    _state.stack = getattr(_state, "stack", ()) + (w,)
    try:
        with w:
            yield w
    finally:
        _state.stack = _state.stack[:-1]


@contextlib.contextmanager
def kernel_call(name: str, work):
    """A hand-written kernel's call: `work()`, its (flops by dtype,
    bytes), goes to the active walk, and the ops dispatched inside are not
    counted.  Outside a walk `work` is not called."""
    w = active()
    if w is None:
        yield
        return
    flops, nbytes = work()
    w.add(name, flops, nbytes)
    w.kernel_depth += 1
    try:
        yield
    finally:
        w.kernel_depth -= 1


def analyze(fn, *args, **kwargs) -> dict:
    """Walk one call of fn(*args, **kwargs) -> {flops, flops_by_dtype,
    hbm_bytes, collective_bytes, by_op, diagnostics}, and the call's
    output under "out" (None when an op could not run, which the
    diagnostics name)."""
    with walk() as w:
        try:
            out = fn(*args, **kwargs)
        except Exception as e:
            if not w.diagnostics:
                w.diagnostics.append(f"{type(e).__name__}: {e}")
            out = None
    res = w.result()
    res["out"] = out
    return res


def totals(res: dict) -> dict:
    """The device-independent part of a walk's result (what meta and card
    walks must agree on)."""
    return {"flops_by_dtype": res["flops_by_dtype"],
            "hbm_bytes": res["hbm_bytes"],
            "collective_bytes": res["collective_bytes"],
            "by_op": res["by_op"]}

"""Spans of the program's work, on the device's clock.

    from repro_torch import spans
    with spans.span("step.forward", island=i):
        ...

Off (the default) `span` returns one shared no-op context after a single
flag check.  Tracing is on after `enable()`, or while a `torch.profiler`
profile is active.  A span opened then:

- enters `torch.profiler.record_function("repro." + name)`, so that it
  is a range in the profiler's chrome trace, on the clock of the kernels
  it launches;
- records a CUDA event on the current stream at each end
  (`time.perf_counter_ns` where CUDA is not in use);
- is kept with an id, its parent's id (the innermost recorded span open
  around it) and its attributes: the context `set_context` set (the
  train loop's `step` and `round`) updated by those it was given.

A span opened while tracing is off stays a no-op even if tracing turns
on before it closes.  `spans()` synchronises once and returns the
finished spans, each with its stream time: from the device reaching the
span's first enqueued work to it finishing the last, idle time inside
included.  `reset()` empties the recorder.  Nothing synchronises while
spans are recorded.  No span sits inside a per-layer, per-leaf or
per-chunk loop.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import time
from typing import Optional

import torch
from torch.autograd import profiler as _profiler

_enabled = False
_NOOP = contextlib.nullcontext()
_context: dict = {}
_open: list = []          # recorded spans open now, innermost last
_done: list = []          # finished spans, in the order they closed
_ids = itertools.count(1)


@dataclasses.dataclass(eq=False)
class Span:
    id: int
    parent: Optional[int]
    name: str
    attrs: dict
    ms: Optional[float] = None      # stream time, set by spans()
    marks: tuple = ()               # (start, end): CUDA events or ns


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def set_context(**attrs) -> None:
    """The attributes every span opened from now on carries (replacing
    the last context)."""
    global _context
    _context = attrs


def span(name: str, **attrs):
    if not (_enabled or _profiler._is_profiler_enabled):
        return _NOOP
    return _Recording(name, attrs)


def _on_card() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_initialized()


def _mark(cuda: bool):
    if cuda:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter_ns()


class _Recording:
    __slots__ = ("name", "attrs", "span", "rf", "cuda")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self) -> Span:
        self.span = Span(next(_ids), _open[-1].id if _open else None,
                         self.name, {**_context, **self.attrs})
        self.rf = torch.profiler.record_function("repro." + self.name)
        self.rf.__enter__()
        self.cuda = _on_card()
        self.span.marks = (_mark(self.cuda),)
        _open.append(self.span)
        return self.span

    def __exit__(self, *exc) -> bool:
        self.span.marks += (_mark(self.cuda),)
        _open.pop()               # spans close innermost first
        self.rf.__exit__(*exc)
        _done.append(self.span)
        return False


def spans() -> list:
    """The finished spans with their stream times in ms (one synchronise
    where a span holds CUDA events)."""
    todo = [s for s in _done if s.ms is None]
    if any(not isinstance(s.marks[0], int) for s in todo):
        torch.cuda.synchronize()
    for s in todo:
        a, b = s.marks
        s.ms = (b - a) * 1e-6 if isinstance(a, int) else a.elapsed_time(b)
    return list(_done)


def reset() -> None:
    _done.clear()

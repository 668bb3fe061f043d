"""The device trace of a profiled sub-window, read from `torch.profiler`'s
chrome trace: every device operation (kernel, copy, set) with its start
and length, the host operations around them, and the window itself (a
`record_function` range named WINDOW)."""
from __future__ import annotations

import bisect
import dataclasses
import json
import os
import tempfile

import torch

WINDOW = "portbench.trace_window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


@dataclasses.dataclass
class Trace:
    device: list          # (name, start_us, dur_us)
    host: list            # (name, start_us, dur_us)
    t0: float             # the window, in the trace's microseconds
    t1: float

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def clipped(self):
        """Device intervals clipped to the window, (start, end) in us."""
        out = []
        for _, s, d in self.device:
            a, b = max(s, self.t0), min(s + d, self.t1)
            if b > a:
                out.append((a, b))
        return out

    def busy_s(self) -> float:
        """Seconds in which some device operation ran: the union of the
        intervals, so overlapping operations count once."""
        return sum(b - a for a, b in union(self.clipped())) * 1e-6

    def device_time_s(self, match) -> float:
        """Summed device time of the operations whose name `match`es."""
        return sum(d for n, s, d in self.device if match(n)) * 1e-6

    def top_ops(self, n: int = 10) -> list:
        tot: dict = {}
        for name, _, d in self.device:
            tot[name] = tot.get(name, 0.0) + d * 1e-6
        return sorted(([k, v] for k, v in tot.items()),
                      key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10) -> list:
        """Idle time of the device summed by what the host was doing at
        the middle of each gap (the innermost host range there)."""
        busy = union(self.clipped())
        gaps, cur = [], self.t0
        for a, b in busy:
            if a > cur:
                gaps.append((cur, a))
            cur = max(cur, b)
        if self.t1 > cur:
            gaps.append((cur, self.t1))
        host = sorted((h for h in self.host if h[0] != WINDOW),
                      key=lambda h: h[1])
        starts = [h[1] for h in host]
        tot: dict = {}
        for a, b in gaps:
            mid = (a + b) / 2
            label, best = "host: nothing recorded", None
            # the innermost range around mid starts shortly before it
            for name, s, d in host[max(0, bisect.bisect_right(starts, mid)
                                       - 256):bisect.bisect_right(starts,
                                                                  mid)]:
                if s + d >= mid and (best is None or d < best):
                    label, best = name, d
            tot[label] = tot.get(label, 0.0) + (b - a) * 1e-6
        return sorted(([k, v] for k, v in tot.items()),
                      key=lambda kv: -kv[1])[:n]


def union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


class Profiler:
    """start() ... stop() -> Trace.  The window is synchronised at both
    ends; the chrome trace goes to a temporary file (under TMPDIR) that is
    read and deleted."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.prof = None
        self.rf = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def warm(self):
        """One short session in set-up, so that the profiler's one-time
        start (CUPTI's) is not paid inside the window."""
        self.start()
        torch.ones(8, device=self.device).sum()
        self._sync()
        self.rf.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.prof = None

    def start(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._sync()
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self.rf = torch.profiler.record_function(WINDOW)
        self.rf.__enter__()

    def stop(self) -> Trace:
        self._sync()
        self.rf.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self.prof = None
        return parse(events)


def parse(events) -> Trace:
    device, host, win = [], [], None
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        item = (e.get("name", ""), float(e["ts"]), float(e.get("dur", 0.0)))
        if cat in DEVICE_CATS:
            device.append(item)
        elif cat in HOST_CATS:
            host.append(item)
            if item[0] == WINDOW and cat == "user_annotation":
                win = item
    if win is None:
        raise RuntimeError("the profiled window left no range in the trace")
    return Trace(device, host, win[1], win[1] + win[2])

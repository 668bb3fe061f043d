"""What the program records of itself (`repro_torch.spans`) and the
ranges its spans leave in the device trace (`repro.<name>`), as the
per-layer metrics read them.  A program without that module, or a run
that recorded nothing, leaves nothing to read: each function then
returns None.  The traced run profiles one exchange round; the program
records spans only while the profiler runs, and the reference runs after
the window, unprofiled."""
import statistics

PHASES = ("step.forward", "step.backward", "step.optimizer")
STEP_RANGE = "repro.train.step"


def recorded():
    """The program's finished spans, or None."""
    try:
        from repro_torch import spans
    except ImportError:
        return None
    return spans.spans() or None


def step_phase_ms(run, name: str):
    """Median over the traced steps of `name`'s summed stream time over
    the islands (and microbatches), taking only the steps in which every
    phase of every island was recorded."""
    sps = recorded()
    if sps is None:
        return None
    islands = set(range(run.traffic.get("islands", 1)))
    seen, total = {}, {}
    for sp in sps:
        if sp.name in PHASES and "step" in sp.attrs:
            k = sp.attrs["step"]
            seen.setdefault(k, set()).add((sp.name,
                                           sp.attrs.get("island", 0)))
            if sp.name == name:
                total[k] = total.get(k, 0.0) + sp.ms
    whole = {(p, i) for p in PHASES for i in islands}
    ms = [total[k] for k in total if seen[k] >= whole]
    return statistics.median(ms) if ms else None


def mean_ms(name: str):
    """Mean stream time of the recorded spans called `name`."""
    ms = [sp.ms for sp in recorded() or () if sp.name == name]
    return statistics.fmean(ms) if ms else None


def _outermost(calls):
    """(start, end) intervals with those inside another one left out (a
    `cuLaunchKernel` made inside the `cudaLaunchKernel` that launched
    it)."""
    out = []
    for a, b in sorted(calls, key=lambda c: (c[0], -c[1])):
        if not out or a >= out[-1][1]:
            out.append((a, b))
    return out


def per_step_range(run, match):
    """Median over the complete `repro.train.step` ranges of the traced
    window of the host calls whose name `match`es that start inside the
    range (None without such a range)."""
    tr = run.record.trace
    if tr is None:
        return None
    ranges = [(s, s + d) for n, s, d in tr.host
              if n == STEP_RANGE and s >= tr.t0 and s + d <= tr.t1]
    if not ranges:
        return None
    calls = _outermost((s, s + d) for n, s, d in tr.host if match(n))
    return statistics.median(sum(1 for a, _ in calls if r0 <= a < r1)
                             for r0, r1 in ranges)


def is_launch(name: str) -> bool:
    return "LaunchKernel" in name


def is_sync(name: str) -> bool:
    return name.endswith("Synchronize")

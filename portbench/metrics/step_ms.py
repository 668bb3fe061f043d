"""Median time of one train step in the window (all islands, the
exchange excluded): the benchmark's span around the program's step,
ending in a synchronise, as `launch/train.main` times its `step_ms`."""
import statistics


def read(run):
    d = run.record.durations("step")
    return statistics.median(d) * 1e3 if d else None

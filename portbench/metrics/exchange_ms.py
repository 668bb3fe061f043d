"""Mean time of one exchange in the window: the benchmark's span around
the whole exchange (the callable `launch/steps.make_fl_aggregate`
returns, or both hops of `core/hierarchy.hierarchical_sync_aggregate`
through fog cells), synchronised at both ends (recorded in the traced
run)."""
import statistics


def read(run):
    d = run.record.durations("exchange")
    return statistics.fmean(d) * 1e3 if d else None

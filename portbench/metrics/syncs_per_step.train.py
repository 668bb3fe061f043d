"""Host synchronisations a train step: the calls whose name ends in
`Synchronize` that start inside a complete `repro.train.step` range of
the trace, per such range (the median; one range in the traced round).
The benchmark's step hook adds one a step in the traced run (after
the step, to time it)."""
from portbench import program_spans


def read(run):
    return program_spans.per_step_range(run, program_spans.is_sync)

"""Kernel launches a train step: the CUDA API calls whose name holds
`LaunchKernel` (one a launch: a call inside another is left out)
that start inside a complete `repro.train.step` range of the trace, per
such range (the median).  The traced round holds one complete range, its
second step's: the first step's opened before the profiler started."""
from portbench import program_spans


def read(run):
    return program_spans.per_step_range(run, program_spans.is_launch)

"""The train step's forward (the model and the loss) in ms: the median
over the traced steps of the program's `step.forward` spans' summed
stream time over the islands.  The benchmark's step hook starts the
profiler inside the round's first step call, after that step's
`train.step` span opened, so the traced round gives two steps whose
phases were recorded for every island: the median is of two."""
from portbench import program_spans


def read(run):
    return program_spans.step_phase_ms(run, "step.forward")

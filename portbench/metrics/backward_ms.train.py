"""The train step's backward (the gradients, remat's recompute
included) in ms: the median over the traced steps of the program's
`step.backward` spans' summed stream time over the islands.  The traced
round gives two steps whose phases were recorded for every island: the
median is of two."""
from portbench import program_spans


def read(run):
    return program_spans.step_phase_ms(run, "step.backward")

"""The train step's optimizer (global norm, clip, AdamW in place) in ms:
the median over the traced steps of the program's `step.optimizer`
spans' summed stream time over the islands.  The traced round gives two
steps whose phases were recorded for every island: the median is of
two."""
from portbench import program_spans


def read(run):
    return program_spans.step_phase_ms(run, "step.optimizer")

"""The exchange's mix (the mixing contraction, the add to the base, the
cast and unflatten) in ms: the mean stream time of the program's
`exchange.mix` spans.  The traced round holds one flat exchange: the
mean is of one span."""
from portbench import program_spans


def read(run):
    return program_spans.mean_ms("exchange.mix")

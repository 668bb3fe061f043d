"""The exchange's mix (the mixing contraction, the add to the base, the
cast and unflatten) in ms: the mean stream time of the program's
`exchange.mix` spans, one a hop.  The traced rounds hold one flat
exchange (`fl-q8`) or two of two hops each through fog cells
(`fl-fog-e1`): the mean is of a hop."""
from portbench import program_spans


def read(run):
    return program_spans.mean_ms("exchange.mix")

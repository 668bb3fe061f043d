"""The exchange's delta (casts and subtract from the last-sync base) in
ms: the mean stream time of the program's `exchange.delta` spans.  The
traced round holds one flat exchange: the mean is of one span."""
from portbench import program_spans


def read(run):
    return program_spans.mean_ms("exchange.delta")

"""The window's train steps' share of the bf16 peak: the FLOPs a token
that the family's layout counts (`layouts/<family>.train_flops_per_token`:
the active products only, and for a routed layer the experts a token
reaches on this chip; dense: 6 N + 12 L (H D) T, N without the input
embedding table, `roofline.py`) x the tokens of the window's steps /
(their summed step time x 989e12)."""
from portbench import roofline


def read(run):
    d = run.record.durations("step")
    f = run.record.facts
    if not d:
        return None
    flops = f["train_flops_per_token"] * f["tokens_per_step"] * len(d)
    return 100.0 * flops / (sum(d) * roofline.BF16_FLOPS)

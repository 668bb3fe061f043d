"""The window's train steps' share of the bf16 peak: (6 N + 12 L d T) a
token x the tokens of the window's steps / (their summed step time x
989e12), N without the input embedding table (`roofline.py`)."""
from portbench import roofline


def read(run):
    d = run.record.durations("step")
    f = run.record.facts
    if not d:
        return None
    flops = f["train_flops_per_token"] * f["tokens_per_step"] * len(d)
    return 100.0 * flops / (sum(d) * roofline.BF16_FLOPS)

"""The whole training step's share of the card's bf16 peak: the model's
operations an example (``counts.step_flops``: forward and backward, the
CIN in its least-work forms) times the window's examples/s, over the peak
of ``peaks.json``."""

from benchmark import counts


def read(ctx):
    if ctx.get("kind") != "train" or not ctx.get("examples_per_s"):
        return None
    rate = counts.peak(ctx.get("card", ""), "bf16_flops_per_s")
    if rate is None:
        return None
    return 100.0 * counts.step_flops(ctx["config"], 1) * ctx["examples_per_s"] / rate

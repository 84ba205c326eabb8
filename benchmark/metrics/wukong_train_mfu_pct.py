"""The whole Wukong training step's share of the card's bf16 peak: the
model's operations an example (``counts_wukong.step_flops``: forward and
backward products of the bags, the MLPs, the FM, LCB and projection of every
layer) times the window's examples/s, over the peak of ``peaks.json``."""

from benchmark import counts, counts_wukong


def read(ctx):
    cfg = ctx.get("config", {})
    if ctx.get("kind") != "train" or not ctx.get("examples_per_s") or cfg.get("model") != "wukong":
        return None
    rate = counts.peak(ctx.get("card", ""), "bf16_flops_per_s")
    if rate is None:
        return None
    return 100.0 * counts_wukong.step_flops(cfg, 1) * ctx["examples_per_s"] / rate

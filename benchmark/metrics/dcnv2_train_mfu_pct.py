"""The whole DLRM-DCNv2 training step's share of the card's bf16 peak: the
model's operations an example (``counts_dcnv2.step_flops``: forward and
backward, the bag sums, the MLPs and the low-rank cross layers) times the
window's examples/s, over the peak of ``peaks.json``."""

from benchmark import counts, counts_dcnv2


def read(ctx):
    cfg = ctx.get("config", {})
    if ctx.get("kind") != "train" or not ctx.get("examples_per_s") or cfg.get("model") != "dlrm_dcnv2":
        return None
    rate = counts.peak(ctx.get("card", ""), "bf16_flops_per_s")
    if rate is None:
        return None
    return 100.0 * counts_dcnv2.step_flops(cfg, 1) * ctx["examples_per_s"] / rate

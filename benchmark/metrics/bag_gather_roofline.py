"""The pooled bag gather's share of its roofline in a training step: the
bytes the bags need (``counts_dcnv2.bag_gather_bytes``: the traced steps'
mean distinct rows read once, the ids, the pooled bf16 rows written once)
at the card's bandwidth, over the device time a step of the kernel
``bag_gather_kernel`` (selected by its name: ``kernel_map.json`` does not
name it, so its layer is ``unmapped``). The ids a step are the program's
counters, ``emb.bag_lookups`` over ``emb.bag_calls`` (the ids of each bag
gather that was run or captured); a program without them, or a run in which
the kernel did not run, reports nothing."""

from benchmark import counts, counts_dcnv2, program_trace
from benchmark.profile import short_name

KERNEL = "bag_gather_kernel"


def read(ctx):
    t, cfg = ctx.get("trace"), ctx.get("config", {})
    if ctx.get("kind") != "train" or t is None or not t.steps or "unique_rows_per_step" not in ctx:
        return None
    lookups, calls = program_trace.counter("emb.bag_lookups"), program_trace.counter("emb.bag_calls")
    if not lookups or not calls:
        return None
    measured = sum(d for n, _, d in t.device_ops if short_name(n).split("::")[-1] == KERNEL) / 1e6 / t.steps
    out_elem = 2 if cfg.get("compute_dtype") == "bfloat16" else 4
    nbytes = counts_dcnv2.bag_gather_bytes(ctx["unique_rows_per_step"], lookups / calls, ctx["bags_per_step"],
                                           cfg["embed_dim"], out_elem)
    bound = counts.bound_ms(ctx.get("card", ""), nbytes=nbytes)
    if bound is None or measured <= 0:
        return None
    return 100.0 * bound / measured

"""The row gather's (#1) share of its roofline in a training step: the
bytes these batches need (``counts.gather_bytes`` with the traced steps'
mean distinct rows) over the bandwidth, over the device time of the
gather kernels, a step."""

from benchmark import counts


def read(ctx):
    t, cfg = ctx.get("trace"), ctx["config"]
    if ctx.get("kind") != "train" or t is None or not t.steps or "unique_rows_per_step" not in ctx:
        return None
    measured = t.layer_ms("gather") / t.steps
    out_elem = 2 if cfg["compute_dtype"] == "bfloat16" else 4
    nbytes = counts.gather_bytes(ctx["unique_rows_per_step"], ctx["ids_per_step"], cfg["embed_dim"] + 1, out_elem)
    bound = counts.bound_ms(ctx.get("card", ""), nbytes=nbytes)
    if bound is None or measured <= 0:
        return None
    return 100.0 * bound / measured

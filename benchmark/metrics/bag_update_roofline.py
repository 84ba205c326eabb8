"""The sparse Adagrad update's (#4) share of its roofline on a stream of
pooled bags' ids (DLRM-DCNv2, d = 128, no first-order column): the bytes
these batches need (``counts.adagrad_update_bytes`` with the traced steps'
mean distinct rows, every id's expanded bf16 grad read once) at the card's
bandwidth, over the device time a step of the update kernel
(``emb_update`` in ``kernel_map.json``)."""

from benchmark import counts


def read(ctx):
    t, cfg = ctx.get("trace"), ctx.get("config", {})
    if ctx.get("kind") != "train" or t is None or not t.steps or "unique_rows_per_step" not in ctx:
        return None
    measured = t.layer_ms("emb_update") / t.steps
    grad_elem = 2 if cfg.get("compute_dtype") == "bfloat16" else 4
    nbytes = counts.adagrad_update_bytes(ctx["unique_rows_per_step"], ctx["ids_per_step"], cfg["embed_dim"],
                                         grad_elem)
    bound = counts.bound_ms(ctx.get("card", ""), nbytes=nbytes)
    if bound is None or measured <= 0:
        return None
    return 100.0 * bound / measured

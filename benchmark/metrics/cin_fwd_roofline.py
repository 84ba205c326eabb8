"""The CIN forward kernels' share of their roofline in a training step: the
forward's bound (``counts.cin_forward_flops`` at the batch, over the bf16
peak) over the device time, a step, of the kernels the harness's map puts
in ``cin_fwd``, with the re-layout (``cin_relayout``) where no CIN backward
kernel ran (then the re-layout is the forward's). Where a backward kernel
ran beside it, or the fused two-layer path's GEMM (``cin_fused``, which
serves both directions), the forward's time cannot be read apart and
nothing is reported."""

from benchmark import counts


def read(ctx):
    t, cfg = ctx.get("trace"), ctx["config"]
    if ctx.get("kind") != "train" or cfg["model"] != "xdeepfm" or t is None or not t.steps:
        return None
    if t.layer_ms("cin_fused") > 0 or (t.layer_ms("cin_bwd") > 0 and t.layer_ms("cin_relayout") > 0):
        return None
    measured = (t.layer_ms("cin_fwd") + t.layer_ms("cin_relayout")) / t.steps
    flops = counts.cin_forward_flops(ctx["batch_size"], cfg["n_slots"], cfg["embed_dim"], cfg["cin_sizes"])
    bound = counts.bound_ms(ctx.get("card", ""), flops=flops)
    if bound is None or measured <= 0:
        return None
    return 100.0 * bound / measured

"""Device time a training step spends in PyTorch's own operations: every
kernel, copy and set that is neither the port's own kernel (the harness's
map) nor cuBLAS/cuBLASLt/CUTLASS, over the traced steps."""


def read(ctx):
    t = ctx.get("trace")
    if ctx.get("kind") != "train" or t is None or not t.device_ops or not t.steps:
        return None
    return (t.layer_ms("glue") + t.layer_ms("copy")) / t.steps

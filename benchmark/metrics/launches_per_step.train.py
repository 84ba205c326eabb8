"""Kernels the device ran in the traced stretch of training, over its
steps (copies and sets not counted)."""


def read(ctx):
    t = ctx.get("trace")
    if ctx.get("kind") != "train" or t is None or not t.device_ops or not t.steps:
        return None
    return len(t.kernels()) / t.steps

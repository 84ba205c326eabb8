"""Share of the traced stretch of training superbatches in which no device
operation ran (kernels, copies, sets), from the profiler's device events."""


def read(ctx):
    t = ctx.get("trace")
    if ctx.get("kind") != "train" or t is None or not t.device_ops or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)

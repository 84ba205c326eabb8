"""Device time (kernels, copies, sets) in the traced stretch of requests,
over its requests."""


def read(ctx):
    t = ctx.get("trace")
    if ctx.get("kind") != "serve" or t is None or not t.device_ops or not t.requests:
        return None
    return sum(d for _, _, d in t.device_ops) / 1e6 / t.requests

"""The median of the harness's host clock around each ``predict_logits``
call of the window: service time, without the queue."""

import statistics


def read(ctx):
    if ctx.get("kind") != "serve" or not ctx.get("serve_call_ms"):
        return None
    return statistics.median(ctx["serve_call_ms"])

"""The host's time for one replay of the captured training step: the mean of
the program's ``train.step`` spans (state key, copy into the static
buffers, graph launch) over the traced stretch, by the profiler's host
clock."""

from benchmark import program_trace


def read(ctx):
    t = ctx.get("trace")
    if ctx.get("kind") != "train" or t is None:
        return None
    steps = program_trace.spans(t, "train.step")
    if not steps:
        return None
    return sum(b - a for a, b in steps) / len(steps) / 1e6

"""Device time a training step spends in the row gather: the group ids, the
tables' plan and the gather kernel (#1): the median over the traced
stretch's samples of the program's ``step.gather`` phase, timed by CUDA
events in the timed twin of the step's graph (about one sample a
superbatch)."""

from benchmark import program_trace


def read(ctx):
    return program_trace.phase_ms(ctx, "step.gather")

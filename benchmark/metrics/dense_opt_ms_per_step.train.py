"""Device time a training step spends in the dense optimizer's update (Adam's
``_foreach`` kernels): the median over the traced stretch's samples of the
program's ``step.dense_opt`` phase, timed by CUDA events in the timed twin
of the step's graph (about one sample a superbatch)."""

from benchmark import program_trace


def read(ctx):
    return program_trace.phase_ms(ctx, "step.dense_opt")

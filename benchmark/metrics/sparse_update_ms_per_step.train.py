"""Device time a training step spends in the sparse update (the lr, the
per-slot sort, the grads' permute, the update kernel #4 and the step): the
median over the traced stretch's samples of the program's
``step.sparse_update`` phase, timed by CUDA events in the timed twin of the
step's graph (about one sample a superbatch)."""

from benchmark import program_trace


def read(ctx):
    return program_trace.phase_ms(ctx, "step.sparse_update")

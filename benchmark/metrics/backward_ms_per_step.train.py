"""Device time a training step spends in the backward pass
(``torch.autograd.grad``: the CIN's einsum backward where no kernel takes
its width, the MLP's GEMMs): the median over the traced stretch's samples of
the program's ``step.backward`` phase, timed by CUDA events in the timed
twin of the step's graph (about one sample a superbatch)."""

from benchmark import program_trace


def read(ctx):
    return program_trace.phase_ms(ctx, "step.backward")

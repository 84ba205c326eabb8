"""Set-up spent capturing CUDA graphs: the program's counter
``graph.capture_s``, the host time of every capture (each training graph and
its timed twin)."""

from benchmark import program_trace


def read(ctx):
    return program_trace.counter("graph.capture_s")

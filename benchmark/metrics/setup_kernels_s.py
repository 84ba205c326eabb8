"""Set-up spent loading the program's CUDA kernel library: the program's
counter ``kernels.load_s``, the host time of the first
``ops/cuda/build.library()`` (nvcc where this checkout has not built it
yet, else the library's load)."""

from benchmark import program_trace


def read(ctx):
    return program_trace.counter("kernels.load_s")

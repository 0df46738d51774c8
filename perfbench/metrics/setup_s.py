"""setup_s (s): process start to the first timed fit: imports, the CUDA
context, the kernels loaded (built by the first run in a checkout), the rows
made, the warm-up fit."""


def read(ctx):
    return ctx["setup_s"]

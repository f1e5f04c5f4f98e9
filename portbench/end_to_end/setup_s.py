"""setup_s: from the start of run.py to the first timed push: importing,
building or loading the CUDA kernels and the native runtime, making the
traffic, staging it, and the warm-up pushes."""


def read(ctx):
    return ctx.setup_s

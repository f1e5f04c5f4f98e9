"""h2d_ms (layer: io feed): device ms a block of the trace's "Memcpy HtoD"
operations, the copies DeviceFeed makes of each staged block."""


def read(ctx):
    if ctx.trace is None:
        return None
    t = ctx.trace.seconds(r"^Memcpy HtoD")
    return None if t is None else t / ctx.trace.pushes * 1e3

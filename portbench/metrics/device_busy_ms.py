"""device_busy_ms (layer: device): the union of the device's kernel, copy
and set intervals in the traced stretch, per push."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.device:
        return None
    return ctx.trace.busy_s / ctx.trace.pushes * 1e3

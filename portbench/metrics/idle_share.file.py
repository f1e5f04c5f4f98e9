"""idle_share.file (layer: device), in %: idle_share for the file cell,
100 * (1 - the device's busy time per push in the traced stretch / the wall
time per push of the untraced window).  The traced stretch's own wall time
carries the profiler's host cost, so the window's stands for the stretch's."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.device or not ctx.pushes:
        return None
    busy = ctx.trace.busy_s / ctx.trace.pushes
    return 100.0 * (1.0 - busy / (ctx.wall_s / ctx.pushes))

"""channelizer_ms (layer: channelizer): device ms a push of the wideband
receiver's channelizer stage, everything the device runs from the start
of the kernel named pfb_kernel (csrc/pfb.cu) up to the detection's first
kernel (names holding "sc_detect"): today pfb, the channelizer's tail copy
and the channel-major transpose (modem/wideband.py).  pfb_roofline holds
the kernel alone; a change that moves the transpose's work into pfb reads
lower there and shows here as the stage's gain."""


def read(ctx):
    if ctx.trace is None or "pfb" not in ctx.path.work():
        return None
    t = ctx.trace.stage_seconds(r"pfb_kernel", r"sc_detect\w*kernel")
    return None if t is None else t / ctx.trace.pushes * 1e3

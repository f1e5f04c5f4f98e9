"""pfb_roofline (layer: kernels), in %: the least time the channelizer's
work can take (roofline.pfb_seconds, from the shapes: every wideband
sample read once and its channel sample written once) over the device
time per push of the kernel named pfb_kernel (csrc/pfb.cu).  The
channel-major transpose after it is not in the denominator."""

from portbench import roofline


def read(ctx):
    work = ctx.path.work().get("pfb")
    if ctx.trace is None or work is None:
        return None
    t = ctx.trace.seconds(r"pfb_kernel")
    if t is None:
        return None
    return 100.0 * roofline.pfb_seconds(**work) / (t / ctx.trace.pushes)

"""detect_roofline (layer: kernels), in %: the least time the Schmidl-Cox
detection's work can take (roofline.detect_seconds, from the shapes:
every virtual-buffer sample read once, the detections written once) over
the device time per push of the kernels whose names hold "sc_detect"
(csrc/sc_detect.cu: sc_detect_l32_kernel, sc_detect_seg_kernel,
sc_detect_kernel)."""

from portbench import roofline


def read(ctx):
    if ctx.trace is None:
        return None
    t = ctx.trace.seconds(r"sc_detect\w*kernel")
    if t is None:
        return None
    return 100.0 * roofline.detect_seconds(**ctx.path.work()["detect"]) \
        / (t / ctx.trace.pushes)

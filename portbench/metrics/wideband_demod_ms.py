"""wideband_demod_ms (layer: demod): device ms a push of the wideband
receiver's demod stage, everything the device runs from the start of the
port's slot-window gather (gather_kernel, csrc/gather.cu) up to the next
channelizer kernel (pfb_kernel), detection kernel (names holding
"sc_detect") or copy to the host ("Memcpy DtoH"): the gather, the demod
graph's kernels over the n_chan x K slots and the outputs' copy out of the
graph pool and the history's copy.  demod_ms's stage ends only at a
detection or a copy to the host; a wideband push's next detection comes
after the next push's pfb, so wherever no copy to the host comes between
two pushes, demod_ms would take in that pfb.  Here pfb closes the stage
too.  torch's own gather kernel does not open it."""

GATHER = r"\bgather_kernel\b"
UNTIL = r"pfb_kernel|sc_detect\w*kernel|^Memcpy DtoH"


def read(ctx):
    if ctx.trace is None:
        return None
    t = ctx.trace.stage_seconds(GATHER, UNTIL)
    return None if t is None else t / ctx.trace.pushes * 1e3

"""demod_ms (layer: demod): device ms a push of the narrowband receiver's
demod stage, everything the device runs from the start of the port's
slot-window gather (gather_kernel, csrc/gather.cu) up to the next
detection kernel (names holding "sc_detect") or the next copy to the host
("Memcpy DtoH", the sink's): the gather, the demod graph's kernels (the
derotation, the FFTs, the integer-CFO search and roll, the estimate, the
equalisation, the demap, the CRC, the EVM) and the outputs' copy out of the
graph pool.  torch's own gather kernel (at::native::vectorized_gather_kernel,
which also runs a push) does not open the stage."""

GATHER = r"\bgather_kernel\b"
UNTIL = r"sc_detect\w*kernel|^Memcpy DtoH"


def read(ctx):
    if ctx.trace is None:
        return None
    t = ctx.trace.stage_seconds(GATHER, UNTIL)
    return None if t is None else t / ctx.trace.pushes * 1e3

"""input_msps: every input sample the window pushed (the RX half's, for
the radio) over the window's whole wall time, in Msamples/s."""


def read(ctx):
    return ctx.samples / ctx.wall_s / 1e6

"""file_msps: the capture file's samples decoded in the window (file ->
FileStreamer -> DeviceFeed -> receiver -> frames on the host) over the
window's wall time, in Msamples/s."""


def read(ctx):
    return ctx.samples / ctx.wall_s / 1e6

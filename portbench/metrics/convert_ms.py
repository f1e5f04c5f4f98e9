"""convert_ms (layer: runtime): host ms a block in FileStreamer.read_into,
the wait for the reader thread's bytes plus the i16c conversion into the
feed's pinned planes (FileStreamer.last_times), the mean over the blocks
read during the window."""


def read(ctx):
    t = ctx.counters.get("convert")
    return sum(a + b for a, b in t) / len(t) * 1e3 if t else None

"""enqueue_ms (layer: executor): host ms inside StreamExecutor.push, the
mean over the window's pushes (for the radio the TX and RX halves' one
push; the air hop is apart)."""


def read(ctx):
    t = ctx.spans.get("push")
    return sum(t) / len(t) * 1e3 if t else None

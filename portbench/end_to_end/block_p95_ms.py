"""block_p95_ms: the 95th percentile, over every block of the window, of
the time from the start of the block's push to the moment its frames are
on the host."""

import numpy as np


def read(ctx):
    return float(np.percentile(ctx.latencies, 95)) * 1e3

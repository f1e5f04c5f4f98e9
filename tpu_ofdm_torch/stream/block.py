"""Streaming block contract (counterpart of the `Block` dataclass in
tpu_ofdm/stream/block.py).

A Block is a pair of functions:

    init(device)      -> state            (history buffers, counters)
    apply(state, x)   -> (state, y)       (one time-block of samples)

State lives on the device given to `init`; `apply` runs eagerly on the
tensors' device and returns the new state rather than mutating the old.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable


@dataclasses.dataclass(frozen=True)
class Block:
    """A streaming processor.

    `latency`: samples of pipeline delay before an input sample's effect is
    fully emitted (e.g. the RX history carry).  The executor flushes this
    many zero samples at end of stream so trailing outputs are not lost."""

    init: Callable[[Any], Any]
    apply: Callable[[Any, Any], tuple[Any, Any]]
    latency: int = 0

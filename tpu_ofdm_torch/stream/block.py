"""Streaming block contract (counterpart of the `Block` dataclass in
tpu_ofdm/stream/block.py).

A Block is a pair of functions:

    init(device)      -> state            (history buffers, counters)
    apply(state, x)   -> (state, y)       (one time-block of samples)

State lives on the device given to `init`; `apply` runs eagerly on the
tensors' device and returns the new state rather than mutating the old.
`stateless`, `chain` and `complex_to_mag_squared` are the JAX module's
composition helpers and one of its utility blocks.
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
    # False for blocks whose input is not one block of samples (the
    # streaming TX takes PDU slot batches); the executor then skips its
    # block-size and device checks.
    stream_input: bool = True


def stateless(fn: Callable[[Any], Any]) -> Block:
    """Lift a pure function of one time-block into a Block with no
    state."""
    return Block(init=lambda device: (), apply=lambda s, x: (s, fn(x)))


def chain(*blocks: Block) -> Block:
    """Sequential composition: y flows through the blocks in order; their
    states are carried as a tuple."""

    def init(device):
        return tuple(b.init(device) for b in blocks)

    def apply(states, x):
        new_states = []
        for b, s in zip(blocks, states):
            s, x = b.apply(s, x)
            new_states.append(s)
        return tuple(new_states), x

    return Block(init=init, apply=apply)


def complex_to_mag_squared() -> Block:
    return stateless(lambda x: x.abs() ** 2)

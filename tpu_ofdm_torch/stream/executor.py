"""Block-streaming executor (counterpart of tpu_ofdm/stream/executor.py).

Splits a sample stream into fixed-size time-blocks and threads the block's
carry from one step to the next.  JAX ran each step as one jitted program
with a donated carry; here each step runs eagerly on the carry's device and
returns the new carry.  A step enqueues its kernels and never waits on the
host (no .item(), nonzero or boolean-mask indexing anywhere on the path), so
on a GPU the Python loop runs ahead of the device as JAX's async dispatch
did.

A push takes one tensor or a tuple / NamedTuple of them (a multi-input
flowgraph's streams, the radio's (TxStreamIn, samples)).  Numpy leaves are
copied onto the executor's device, 64-bit types as their 32-bit ones, as
JAX takes numpy; that copy waits on the host, so a path that must not
stages its inputs on the device first.
"""

from __future__ import annotations

import time
from typing import Any

import numpy as np
import torch

from tpu_ofdm_torch.stream.block import Block

# numpy types as JAX (64-bit mode off) and so the JAX executor take them
_NARROW = {np.dtype(np.float64): np.float32,
           np.dtype(np.complex128): np.complex64,
           np.dtype(np.int64): np.int32, np.dtype(np.uint64): np.uint32}


def tree_map(fn, *trees):
    """fn over the leaves of equally shaped trees of tuples, NamedTuples
    and lists (a Block's inputs, states and outputs)."""
    t = trees[0]
    if isinstance(t, (tuple, list)):
        kids = [tree_map(fn, *parts) for parts in zip(*trees)]
        if hasattr(t, "_fields"):
            return type(t)(*kids)
        return type(t)(kids)
    return fn(*trees)


def tree_leaves(tree) -> list:
    leaves = []
    tree_map(leaves.append, tree)
    return leaves


def to_device(x, device):
    """A numpy array (or anything np.asarray takes that is not a tensor)
    -> a tensor on `device`, 64-bit types narrowed (a read-only array, as
    a file source yields, copied); tensors pass as they are."""
    if isinstance(x, torch.Tensor):
        return x
    a = np.asarray(x)
    a = a.astype(_NARROW.get(a.dtype, a.dtype), copy=not a.flags.writeable)
    return torch.as_tensor(a, device=device)


def pad_to_blocks(samples: torch.Tensor, block_size: int):
    """Zero-pad to a whole number of blocks; returns (blocks (...,
    n_blocks, block_size), n_valid)."""
    n = samples.shape[-1]
    n_blocks = max(1, -(-n // block_size))
    pad = n_blocks * block_size - n
    if pad:
        z = samples.new_zeros((*samples.shape[:-1], pad))
        samples = torch.cat([samples, z], dim=-1)
    return samples.reshape(*samples.shape[:-1], n_blocks, block_size), n


def scan_blocks(block: Block, state: Any, blocks, device="cuda"):
    """Run a Block over stacked time-blocks (..., n_blocks, block_size),
    one step per block along axis -2, as the JAX package's lax.scan does.
    Returns (final_state, outputs): every output leaf stacked along a new
    leading axis of n_blocks.  Numpy blocks are copied to `device` (the
    card unless the caller names the CPU), where `state` must be."""
    blocks = to_device(blocks, device)
    outs = []
    for i in range(blocks.shape[-2]):
        state, y = block.apply(state, blocks[..., i, :])
        outs.append(y)
    return state, tree_map(lambda *ys: torch.stack(ys), *outs)


class StreamExecutor:
    """Open-ended streaming driver around a Block.

    Keeps the carry across run() calls and exposes throughput counters.
    `device` is where the carry lives (the card unless the caller asks
    for the CPU); every pushed block must be there.  On a GPU,
    `samples_per_sec` counts the host's enqueue time, as the JAX executor's
    did: end a timing with a readback of a result."""

    def __init__(self, block: Block, block_size: int, device="cuda"):
        self.block = block
        self.block_size = block_size
        self.device = torch.empty(0, device=device).device  # resolve index
        self.state = block.init(self.device)
        self.samples_in = 0
        self.wall_time = 0.0

    def reset(self):
        self.state = self.block.init(self.device)
        self.samples_in = 0
        self.wall_time = 0.0

    def push(self, block_samples) -> Any:
        """Process one time-block: a tensor or a tuple of them, each of
        exactly block_size samples on the executor's device (numpy leaves
        are copied there), or the block's own input when it is not a
        stream of samples."""
        block_samples = tree_map(lambda a: to_device(a, self.device),
                                 block_samples)
        if self.block.stream_input:
            for leaf in tree_leaves(block_samples):
                if leaf.shape[-1] != self.block_size:
                    raise ValueError(f"block of {leaf.shape[-1]} samples, "
                                     f"expected {self.block_size}")
                if leaf.device != self.device:
                    raise ValueError(f"block on {leaf.device}, executor "
                                     f"on {self.device}")
        t0 = time.perf_counter()
        self.state, out = self.block.apply(self.state, block_samples)
        self.samples_in += self.block_size
        self.wall_time += time.perf_counter() - t0
        return out

    def run(self, samples, drain: bool = False) -> list:
        """Feed a sample tensor or numpy array through as consecutive
        time-blocks (zero-padding the tail); returns the per-block outputs.

        drain=True flushes the block's latency with zero blocks (so a frame
        near the end of the stream, whose ownership window lags by the
        history length, is still reported) and waits for the device."""
        samples = to_device(samples, self.device).to(self.device)
        blocks, _ = pad_to_blocks(samples, self.block_size)
        outs = [self.push(blocks[..., i, :]) for i in range(blocks.shape[-2])]
        if drain:
            n_flush = -(-self.block.latency // self.block_size)
            z = blocks.new_zeros((*blocks.shape[:-2], self.block_size))
            outs.extend(self.push(z) for _ in range(n_flush))
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        return outs

    @property
    def samples_per_sec(self) -> float:
        return self.samples_in / self.wall_time if self.wall_time else 0.0

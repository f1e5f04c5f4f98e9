"""Block-streaming executor (counterpart of tpu_ofdm/stream/executor.py).

Splits a sample stream into fixed-size time-blocks and threads the block's
carry from one step to the next.  JAX ran each step as one jitted program
with a donated carry; here each step runs eagerly on the carry's device and
returns the new carry.  A step enqueues its kernels and never waits on the
host (no .item(), nonzero or boolean-mask indexing anywhere on the path), so
on a GPU the Python loop runs ahead of the device as JAX's async dispatch
did.
"""

from __future__ import annotations

import time
from typing import Any

import torch

from tpu_ofdm_torch.stream.block import Block


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

    def push(self, block_samples: torch.Tensor) -> Any:
        """Process one time-block: exactly block_size samples, or the
        block's own input when it is not a stream of samples."""
        if self.block.stream_input:
            if block_samples.shape[-1] != self.block_size:
                raise ValueError(f"block of {block_samples.shape[-1]} "
                                 f"samples, expected {self.block_size}")
            if block_samples.device != self.device:
                raise ValueError(f"block on {block_samples.device}, "
                                 f"executor on {self.device}")
        t0 = time.perf_counter()
        self.state, out = self.block.apply(self.state, block_samples)
        self.samples_in += self.block_size
        self.wall_time += time.perf_counter() - t0
        return out

    def run(self, samples: torch.Tensor, drain: bool = False) -> list:
        """Feed a sample tensor through as consecutive time-blocks
        (zero-padding the tail); returns the per-block outputs.

        drain=True flushes the block's latency with zero blocks (so a frame
        near the end of the stream, whose ownership window lags by the
        history length, is still reported) and waits for the device."""
        blocks, _ = pad_to_blocks(samples.to(self.device), self.block_size)
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

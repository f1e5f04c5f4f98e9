"""Checkpoint/resume for streaming-executor state (counterpart of
tpu_ofdm/stream/checkpoint.py).

The executor's whole carry is an explicit tree of tensors, so persisting it
is simple: a restarted process resumes mid-stream with frame sync, channel
estimates, and sample counters intact.

Layout of a checkpoint directory:
  state.pt   torch.save of {"leaf_i": CPU tensor}, the carry's leaves in
             tree_leaves order (read back with weights_only=True)
  meta.json  the JAX package's keys: samples_in, block_size, block_name,
             n_leaves, and the caller's meta
Tensors are saved from the CPU and restored onto the executor's device, so
a checkpoint saved on the card resumes on the CPU and the reverse.  A JAX
checkpoint's leaves (Orbax) go through the stream block's carry_from_jax.
"""

from __future__ import annotations

import json
import os

import torch

from tpu_ofdm_torch.stream.executor import StreamExecutor, tree_leaves, tree_map

STATE_FILE = "state.pt"
META_FILE = "meta.json"


def save_state(path: str, executor: StreamExecutor, meta: dict | None = None):
    """Persist an executor's carry + counters to `path` (a directory)."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    # a compact CPU copy of each leaf: torch.save writes a view's whole
    # storage (the TX carry is a view of a larger buffer)
    leaves = [torch.as_tensor(v).detach().cpu().clone()
              for v in tree_leaves(executor.state)]
    torch.save({f"leaf_{i}": v for i, v in enumerate(leaves)},
               os.path.join(path, STATE_FILE))
    with open(os.path.join(path, META_FILE), "w") as f:
        json.dump(
            {
                "samples_in": executor.samples_in,
                "block_size": executor.block_size,
                "block_name": executor.block.name,
                "n_leaves": len(leaves),
                **(meta or {}),
            },
            f,
        )


def load_state(path: str, executor: StreamExecutor) -> dict:
    """Restore a checkpoint into `executor` (must wrap the same Block
    configuration), onto the executor's device.  Returns the checkpoint
    metadata.  Raises ValueError where the block size, the leaf count, or
    a leaf's shape or dtype differs from the block's own init."""
    path = os.path.abspath(path)
    with open(os.path.join(path, META_FILE)) as f:
        meta = json.load(f)
    if meta["block_size"] != executor.block_size:
        raise ValueError(
            f"checkpoint block_size {meta['block_size']} != executor "
            f"{executor.block_size}"
        )
    saved = torch.load(os.path.join(path, STATE_FILE), weights_only=True,
                       map_location=executor.device)
    leaves = [saved[f"leaf_{i}"] for i in range(meta["n_leaves"])]
    template = executor.block.init(executor.device)
    want = tree_leaves(template)
    if len(want) != len(leaves):
        raise ValueError(
            f"checkpoint has {len(leaves)} leaves, block expects "
            f"{len(want)} -- config mismatch?"
        )
    for i, (a, b) in enumerate(zip(want, leaves)):
        if tuple(a.shape) != tuple(b.shape):
            raise ValueError(f"leaf {i} shape mismatch {tuple(b.shape)} vs "
                             f"{tuple(a.shape)}")
        if a.dtype != b.dtype:
            raise ValueError(f"leaf {i} dtype mismatch {b.dtype} vs "
                             f"{a.dtype}")
    it = iter(leaves)
    executor.state = tree_map(lambda _: next(it), template)
    executor.samples_in = meta["samples_in"]
    return meta


def resume_step(meta: dict) -> int:
    """Stream step index to continue from (samples_in / block_size)."""
    return meta["samples_in"] // meta["block_size"]

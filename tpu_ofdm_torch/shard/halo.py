"""Overlap-save halo exchange across time shards (counterpart of
tpu_ofdm/shard/halo.py).

Each time shard fetches the trailing `halo` samples of its LEFT neighbour
with one ring `ppermute` step over the mesh's communicator.  Shard 0
receives zeros (ppermute's semantics for destinations no source maps to),
which matches stream start: the capture is preceded by silence.  The last
shard likewise receives zeros from the right.

The functions take the list of this process's shards (see shard.mesh) and
return one tensor per shard.
"""

from __future__ import annotations

import torch

from tpu_ofdm_torch.shard.mesh import TIME_AXIS, Mesh


def halo_from_left(xs: list, halo: int, mesh: Mesh,
                   axis_name=TIME_AXIS) -> list:
    """The trailing `halo` samples (last axis) of each shard's left
    neighbour along `axis_name`; zeros on the first shard."""
    n = len(mesh.comm.members(mesh.comm.shards[0], axis_name))
    tails = [x[..., x.shape[-1] - halo:] for x in xs]
    if n == 1:
        return [torch.zeros_like(t) for t in tails]
    perm = [(i, i + 1) for i in range(n - 1)]  # i sends to i+1; 0 gets zeros
    return mesh.comm.ppermute(tails, axis_name, perm)


def halo_from_right(xs: list, halo: int, mesh: Mesh,
                    axis_name=TIME_AXIS) -> list:
    """The leading `halo` samples of each shard's right neighbour along
    `axis_name`; zeros on the last shard (lookahead halo)."""
    n = len(mesh.comm.members(mesh.comm.shards[0], axis_name))
    heads = [x[..., :halo] for x in xs]
    if n == 1:
        return [torch.zeros_like(h) for h in heads]
    perm = [(i + 1, i) for i in range(n - 1)]
    return mesh.comm.ppermute(heads, axis_name, perm)


def extend_with_left_halo(xs: list, halo: int, mesh: Mesh,
                          axis_name=TIME_AXIS) -> list:
    """[left-neighbour tail | local block] along the last axis."""
    return [torch.cat([h, x], dim=-1)
            for h, x in zip(halo_from_left(xs, halo, mesh, axis_name), xs)]

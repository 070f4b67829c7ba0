"""Halo exchange across tile shards: a ring of point-to-point transfers.

Port of vvc/shard/halo.py, whose `ppermute` ring becomes one
`dist.batch_isend_irecv` per rank (a send to and a receive from each
neighbour on the mesh's 'tile' axis).  The frame is cut into vertical
tile stripes, one per rank along 'tile'; each rank sends its left edge
columns to the left neighbour and its right edge columns to the right
one, so every shard holds the halo columns it needs to filter its own
edge region.  The first tile's left halo and the last tile's right halo
are zeros; at one tile both are zeros and nothing is sent (no rank sends
to itself).  A collective, not a compute kernel: on a gloo group the
columns travel through host memory (vvc_torch.shard.mesh).
"""
from __future__ import annotations

import torch

from vvc_torch.shard.mesh import all_gather_cat, mesh_index, send_recv


def exchange_local(mesh, x: torch.Tensor, halo: int = 8):
    """This rank's stripe x [H, Wt] → (from_left [H, halo], from_right
    [H, halo]): the previous tile's last ``halo`` columns and the next
    tile's first ones (zeros at the ends of the ring)."""
    idx, n = mesh_index(mesh, ("tile",))
    group = mesh.get_group("tile")
    from_left = x.new_zeros((x.shape[0], halo))
    from_right = x.new_zeros((x.shape[0], halo))
    sends = []
    if idx > 0:
        sends.append((x[:, :halo], idx - 1, from_left))
    if idx < n - 1:
        sends.append((x[:, -halo:], idx + 1, from_right))
    got = send_recv(sends, group)
    if idx > 0:
        from_left = got.pop(0)
    if idx < n - 1:
        from_right = got.pop(0)
    return from_left, from_right


def exchange_tile_halos(mesh, stripes: torch.Tensor, halo: int = 8):
    """[T, H, Wt] per-tile stripes, T the mesh's 'tile' size, the same on
    every rank → (left_halo [T, H, halo], right_halo [T, H, halo]):
    left_halo[i] holds the rightmost columns of tile i-1 (zeros for i=0),
    right_halo[i] the leftmost of tile i+1 (zeros for the last).  Each
    rank exchanges only its own stripe's edges with its ring neighbours;
    the halos are then all_gathered so that every rank returns the whole
    result, as vvc's global array."""
    idx, n = mesh_index(mesh, ("tile",))
    if stripes.shape[0] != n:
        raise ValueError(f"exchange_tile_halos: {stripes.shape[0]} stripes "
                         f"on a mesh of {n} tiles")
    fl, fr = exchange_local(mesh, stripes[idx], halo)
    group = mesh.get_group("tile")
    return (all_gather_cat(fl[None], group), all_gather_cat(fr[None], group))

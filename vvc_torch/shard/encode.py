"""Sharded frame/GOP encode: the RDO search fanned out over a
(frame × tile) mesh of ranks, byte-identical to the single-card encoder.

Port of vvc/shard/encode.py.  The unit of distribution is the per-tile
RDO search (the body of rdo_partition_tiled): tiles cut all prediction
and entropy dependencies, so each rank searches its own (frame, tile)
cells; rank 0 then runs the per-tile DP backtrack, tile reconstruction
and CABAC substream packing exactly as the single-card path does
(`encode_sequence(..., _precomputed_rdo=...)`), so the bytes are the same.

Cell i is frame i // nt, tile i % nt; the cells are dealt to the ranks in
contiguous chunks of k in row-major (frame, tile) order, as vvc's
`P(("frame", "tile"))` flattens its mesh.  Each rank runs
`eval_all_sizes_frames` over its chunk — vvc vmaps `_eval_all_sizes_impl`
over the same chunk, and the chunk size k sets the float32 sum orders of
the chroma costs above 2^24 (10 bit): k > 1 takes the vmapped program's
orders, k = 1 orders of its own; and in every sharded program XLA sums the
8×8 level rates along the rows (ROADMAP §3, `eval_chroma_modes`,
`eval_blocks`).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from vvc_torch import ops
from vvc_torch.shard.mesh import (all_gather_cat, flat_group, in_mesh,
                                  mesh_index, rank_mesh)


def make_encode_mesh(n_frames: int, n_tiles: int):
    """The ("frame", "tile") mesh over the first n_frames · n_tiles ranks."""
    return rank_mesh((n_frames, n_tiles), ("frame", "tile"))


def mesh_shape(n_frames: int, n_tiles: int, n_ranks: int):
    """vvc's choice of (frames, tiles) for a mesh of at most n_ranks: the
    largest tile count dividing both n_tiles and n_ranks, then as many
    frames as the ranks left allow."""
    mt = 1
    for c in range(min(n_tiles, n_ranks), 0, -1):
        if n_tiles % c == 0 and n_ranks % c == 0:
            mt = c
            break
    return min(n_frames, n_ranks // mt), mt


def _frame_major(cells: np.ndarray, wt: int, h: int, with_chroma: bool):
    """Per-cell packed vectors [k, Lin] → the frame-major packing
    eval_all_sizes_frames reads (every y, then every cb, then every cr)."""
    from vvc_torch.enc.rdo import _split_planes, pack_planes
    planes = [_split_planes(c, wt, h, with_chroma) for c in cells]
    ys = np.stack([p[0] for p in planes])
    if not with_chroma:
        return pack_planes(ys)
    return pack_planes(ys, np.stack([p[1] for p in planes]),
                       np.stack([p[2] for p in planes]))


def eval_cells_sharded(mesh, cells: np.ndarray, shapes, qp: int,
                       bit_depth: int, wt: int, h: int, lossless: bool,
                       lfnst: bool, with_chroma: bool, isp: bool = False,
                       device=None) -> np.ndarray:
    """cells [N, Lin] int32 — one packed (y[, cb, cr]) plane vector per
    (frame, tile) cell, frame-major, the same on every rank of the mesh.
    N is padded with zero cells to a multiple of the mesh size; each rank
    searches its chunk of k cells with eval_all_sizes_frames, and the
    packed results are all_gathered.  Returns [N, Lout] int32 on every
    rank of the mesh."""
    from vvc_torch.enc.rdo import eval_all_sizes_frames

    dev = ops.resolve_device(device)
    n = cells.shape[0]
    idx, ndev = mesh_index(mesh, ("frame", "tile"))
    pad = (-n) % ndev
    if pad:
        cells = np.concatenate([cells, np.zeros((pad, cells.shape[1]),
                                                np.int32)])
    k = cells.shape[0] // ndev
    vec = torch.from_numpy(_frame_major(cells[idx * k:(idx + 1) * k], wt, h,
                                        with_chroma)).to(dev)
    out = eval_all_sizes_frames(vec, shapes, qp, bit_depth, wt, h, k,
                                lossless, lfnst, with_chroma, isp,
                                sharded=True)
    return all_gather_cat(out, flat_group(mesh, ("frame", "tile"))) \
        .cpu().numpy()[:n]


def encode_sequence_sharded(frames, qp: int = 32, bit_depth: int = 8,
                            num_tile_cols: int = 2, mesh=None,
                            lossless: bool = False, mtt: bool = False,
                            isp: bool = False, parallel_tiles: bool = True,
                            device=None):
    """All-Intra sequence encode with the RDO fan-out over a mesh of ranks.

    Every rank of the process group calls it with the same arguments
    (vvc_torch.shard.launch.run_ranks).  Byte-identical to
    encode_sequence(frames, qp, num_tile_cols=...): the mesh only changes
    WHERE each (frame, tile) search runs.  mesh: a make_encode_mesh mesh,
    or None for vvc's shape choice over the process group's ranks (ranks
    outside the mesh only take part in making it).  Rank 0 returns the
    (annexb bytes, recons, stats) triple, every other rank None.
    device: None = CUDA (the rank's card), "cpu" = the plain path."""
    from vvc_torch.enc.encoder import encode_sequence, tile_columns
    from vvc_torch.enc.rdo import (_candidate_shapes, pack_planes,
                                   rdo_partition_tiled, unpack_results)

    if not dist.is_initialized():
        raise RuntimeError("encode_sequence_sharded runs on ranks of a "
                           "process group (vvc_torch.shard.launch)")
    h, w = frames[0].y.shape
    ctu, min_cu = 64, 8
    tiles = tile_columns(num_tile_cols, w, ctu)
    widths = {tx1 - tx0 for tx0, tx1 in tiles}
    if len(widths) != 1:
        raise ValueError("sharded encode needs uniform tile columns")
    wt = widths.pop()
    nf, nt = len(frames), len(tiles)
    if mesh is None:
        mesh = make_encode_mesh(*mesh_shape(nf, nt, dist.get_world_size()))
    if not in_mesh(mesh):
        return None

    cclm = not lossless
    shapes = _candidate_shapes(ctu, min_cu, mtt and not lossless)
    cells = []
    for f in frames:
        for tx0, tx1 in tiles:
            cp = ((f.cb[:, tx0 >> 1:tx1 >> 1], f.cr[:, tx0 >> 1:tx1 >> 1])
                  if cclm else (None, None))
            cells.append(pack_planes(f.y[:, tx0:tx1], *cp))
    packed = eval_cells_sharded(mesh, np.stack(cells), shapes, qp, bit_depth,
                                wt, h, lossless, not lossless, cclm,
                                isp and not lossless, device)
    if dist.get_rank() != 0:
        return None
    rdo_list = []
    for i, f in enumerate(frames):
        tr = [unpack_results(packed[i * nt + t], shapes, wt, h)
              for t in range(nt)]
        rdo_list.append(rdo_partition_tiled(
            f.y, tiles, qp, bit_depth, ctu, min_cu, lossless=lossless,
            lfnst=not lossless, mtt=mtt and not lossless, tile_results=tr,
            isp=isp and not lossless))
    return encode_sequence(frames, qp=qp, bit_depth=bit_depth,
                           num_tile_cols=num_tile_cols, lossless=lossless,
                           mtt=mtt, isp=isp, parallel_tiles=parallel_tiles,
                           _precomputed_rdo=rdo_list, device=device)

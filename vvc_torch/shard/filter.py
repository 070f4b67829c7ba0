"""Cross-tile loop filtering over the mesh — the halo consumer.

Port of vvc/shard/filter.py.  The sharded encoder keeps each tile's
samples on its own rank; the deblocking taps of the vertical edge AT a
tile boundary need 4 columns from the neighbour, which the ring exchange
of vvc_torch.shard.halo provides.  `deblock_tile_edges` filters only the
tile-boundary vertical edges (BS 2, the all-intra tier), each rank
updating its own columns from both of its halos; interior edges are the
per-tile pass as usual.  At the 8-sample deblocking grid adjacent edges'
±4 windows never overlap, so the result equals the unsharded whole-frame
pass over those edges (`vvc_torch.kernels.deblock._filter_luma_edges_v`).

Each rank's body is one launch of the CUDA kernel `tile_edge_deblock`
(csrc/deblock.cu) on a CUDA tensor; on a CPU tensor, or inside
`ops.plain()`, its plain twin `deblock_stripe_plain` (the transcription of
vvc's `_filter_edge_cols`).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from vvc_torch import ops
from vvc_torch.kernels.deblock import BETA_TABLE, TC_TABLE
from vvc_torch.shard.halo import exchange_local
from vvc_torch.shard.mesh import all_gather_cat, mesh_index


def edge_params(qp: int, bit_depth: int = 8) -> tuple[int, int, int]:
    """(β, tC, maxv) of a BS-2 luma edge at ``qp``: the tables' values
    scaled by << (bit_depth − 8)."""
    qpi = int(np.clip(qp, 0, 63))
    beta = int(BETA_TABLE[qpi]) << (bit_depth - 8)
    tc = int(TC_TABLE[min(qpi + 2, 65)]) << (bit_depth - 8)
    return beta, tc, (1 << bit_depth) - 1


def _filter_edge_cols(seg: torch.Tensor, beta: int, tc: int,
                      maxv: int) -> torch.Tensor:
    """Luma deblock of ONE vertical edge given its 8-column window.

    seg [H, 8] int32 = [p3 p2 p1 p0 q0 q1 q2 q3], H a multiple of 4; BS 2;
    returns the filtered [H, 8] window.  Decisions per 4-row segment from
    its rows 0 and 3; the strong filter clips to ±2tC, then to [0, maxv].
    Plain twin of the `tile_edge_deblock` kernel (vvc/shard/filter.py:35)."""
    h = seg.shape[0]
    if h % 4:
        raise ValueError("_filter_edge_cols: H must be a multiple of 4")
    p3, p2, p1, p0 = seg[:, 0], seg[:, 1], seg[:, 2], seg[:, 3]
    q0, q1, q2, q3 = seg[:, 4], seg[:, 5], seg[:, 6], seg[:, 7]
    dp = (p2 - 2 * p1 + p0).abs()
    dq = (q2 - 2 * q1 + q0).abs()
    dp0, dp3 = dp[0::4], dp[3::4]
    dq0, dq3 = dq[0::4], dq[3::4]
    d = dp0 + dp3 + dq0 + dq3
    seg_on = d < beta
    thr = (5 * tc + 1) >> 1
    strong = (seg_on
              & (2 * (dp0 + dq0) < (beta >> 2))
              & (2 * (dp3 + dq3) < (beta >> 2))
              & ((p3[0::4] - p0[0::4]).abs() + (q0[0::4] - q3[0::4]).abs()
                 < (beta >> 3))
              & ((p0[0::4] - q0[0::4]).abs() < thr)
              & ((p3[3::4] - p0[3::4]).abs() + (q0[3::4] - q3[3::4]).abs()
                 < (beta >> 3))
              & ((p0[3::4] - q0[3::4]).abs() < thr))

    def rows(m):
        return m.repeat_interleave(4)

    on, st = rows(seg_on), rows(strong)
    nr = on & ~st
    c2 = 2 * tc

    def clip(v, lo, hi):
        return torch.minimum(torch.maximum(v, lo), hi)

    sp0 = clip((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3, p0 - c2, p0 + c2)
    sp1 = clip((p2 + p1 + p0 + q0 + 2) >> 2, p1 - c2, p1 + c2)
    sp2 = clip((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3, p2 - c2, p2 + c2)
    sq0 = clip((p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3, q0 - c2, q0 + c2)
    sq1 = clip((p0 + q0 + q1 + q2 + 2) >> 2, q1 - c2, q1 + c2)
    sq2 = clip((p0 + q0 + q1 + 3 * q2 + 2 * q3 + 4) >> 3, q2 - c2, q2 + c2)
    delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4
    n_on = nr & (delta.abs() < 10 * tc)
    dlt = delta.clamp(-tc, tc)
    np0 = (p0 + dlt).clamp(0, maxv)
    nq0 = (q0 - dlt).clamp(0, maxv)
    act = (beta + (beta >> 1)) >> 3
    side_p = rows((dp0 + dp3) < act) & n_on
    side_q = rows((dq0 + dq3) < act) & n_on
    tch = tc >> 1
    dp1v = ((((p2 + p0 + 1) >> 1) - p1 + dlt) >> 1).clamp(-tch, tch)
    dq1v = ((((q2 + q0 + 1) >> 1) - q1 - dlt) >> 1).clamp(-tch, tch)
    np1 = (p1 + dp1v).clamp(0, maxv)
    nq1 = (q1 + dq1v).clamp(0, maxv)
    return torch.stack([
        p3,
        torch.where(st, sp2.clamp(0, maxv), p2),
        torch.where(st, sp1.clamp(0, maxv), torch.where(side_p, np1, p1)),
        torch.where(st, sp0.clamp(0, maxv), torch.where(n_on, np0, p0)),
        torch.where(st, sq0.clamp(0, maxv), torch.where(n_on, nq0, q0)),
        torch.where(st, sq1.clamp(0, maxv), torch.where(side_q, nq1, q1)),
        torch.where(st, sq2.clamp(0, maxv), q2),
        q3,
    ], dim=1).to(torch.int32)


def deblock_stripe_plain(x: torch.Tensor, from_left: torch.Tensor,
                         from_right: torch.Tensor, left: bool, right: bool,
                         beta: int, tc: int, maxv: int) -> torch.Tensor:
    """Plain twin of `tile_edge_deblock`: the stripe x [H, Wt] with its
    left edge (p = from_left [H, 4], q = its first 4 columns) filtered
    where ``left`` and its right edge (p = its last 4 columns, q =
    from_right [H, 4]) where ``right``; only the stripe's own columns
    change.  Returns a new tensor."""
    out = x.clone()
    if left:
        seg = torch.cat([from_left, x[:, :4]], dim=1)
        out[:, :4] = _filter_edge_cols(seg, beta, tc, maxv)[:, 4:]
    if right:
        seg = torch.cat([x[:, -4:], from_right], dim=1)
        out[:, -4:] = _filter_edge_cols(seg, beta, tc, maxv)[:, :4]
    return out


def _deblock_stripe_cuda(x, from_left, from_right, left, right, beta, tc,
                         maxv):
    ops.check_cuda_i32("tile_edge_deblock", x, from_left, from_right)
    h, wt = x.shape
    if h % 4 or wt < 8 or from_left.shape != (h, 4) \
            or from_right.shape != (h, 4):
        raise ValueError("tile_edge_deblock: x [H, Wt] with H % 4 == 0 and "
                         "Wt >= 8, halos [H, 4]")
    out = x.clone()
    fn = ops.lib("tile_edge_deblock").tile_edge_deblock_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    err = fn(out.data_ptr(), x.data_ptr(), from_left.data_ptr(),
             from_right.data_ptr(), h, wt, int(left), int(right), beta, tc,
             maxv, ops.stream_ptr(x))
    ops.launched("tile_edge_deblock", err)
    return out


def deblock_stripe(x: torch.Tensor, from_left: torch.Tensor,
                   from_right: torch.Tensor, left: bool, right: bool,
                   beta: int, tc: int, maxv: int) -> torch.Tensor:
    """One shard's tile-edge deblock (vvc/shard/filter.py:119-131): CUDA
    tensor → csrc/deblock.cu `tile_edge_deblock`; CPU tensor or
    `ops.plain()` → `deblock_stripe_plain`."""
    if ops.use_kernel(x):
        return _deblock_stripe_cuda(x, from_left, from_right, left, right,
                                    beta, tc, maxv)
    return deblock_stripe_plain(x, from_left, from_right, left, right, beta,
                                tc, maxv)


def deblock_tile_edges(mesh, stripes: torch.Tensor, qp: int,
                       bit_depth: int = 8) -> torch.Tensor:
    """Filter the vertical edges AT tile boundaries across the mesh.

    stripes [T, H, Wt] int32 per-tile luma stripes, T the mesh's 'tile'
    size, the same on every rank.  Tiles are CTU-aligned, so every
    boundary is a CU edge (BS 2 in the all-intra tier).  Each rank
    exchanges 4-column halos with its neighbours and filters its own
    stripe's boundary columns in one kernel launch; the stripes are then
    all_gathered.  Returns the filtered [T, H, Wt], equal on every rank to
    the unsharded whole-frame pass over those edges."""
    idx, n = mesh_index(mesh, ("tile",))
    if stripes.shape[0] != n:
        raise ValueError(f"deblock_tile_edges: {stripes.shape[0]} stripes "
                         f"on a mesh of {n} tiles")
    beta, tc, maxv = edge_params(qp, bit_depth)
    x = stripes[idx].contiguous()
    fl, fr = exchange_local(mesh, x, halo=4)
    out = deblock_stripe(x, fl, fr, idx > 0, idx < n - 1, beta, tc, maxv)
    return all_gather_cat(out[None], mesh.get_group("tile"))

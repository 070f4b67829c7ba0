"""In-loop deblocking filter.

TPU-native analog of the reference's LoopFilter
(`VTM/source/Lib/CommonLib/LoopFilter.cpp` →
LoopFilter::loopFilterPic / xDeblockCU / xGetBoundaryStrengthSingle /
xUseStrongFiltering; OpenVVC libovvc/rcn_df.c).  SURVEY.md §2.2: "two grid
passes (V then H); edge-parallel kernel" — deblocking has no sequential
dependency (intra prediction reads *unfiltered* recon), so the whole
frame's vertical edges filter as one vectorized pass, then horizontal.

Round-1 scope (shared by encoder/decoder, [verify] items for spec
alignment): HEVC-core luma filter (strong/normal 4-tap decisions on an
8-sample grid at CU boundaries; VVC's 7/5/3 long-tap luma filter and the
4-sample luma grid land with large-block tools), chroma weak filter,
BS=2 everywhere (all-intra), β/tc tables extended to QP 63 by pattern
continuation.

Implementation: numpy, vectorized over all rows of each edge column (the
per-frame cost is a few ms; a jnp twin drops in for the multi-chip
wavefront once halo exchange carries tile edges — vvc.shard.halo).
"""
from __future__ import annotations

import numpy as np

# β table (qp 0..63): HEVC values through 51, +2/qp continuation [verify]
BETA_TABLE = np.array(
    [0] * 16
    + [6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 20, 22, 24, 26, 28,
       30, 32, 34, 36, 38, 40, 42, 44, 46, 48, 50, 52, 54, 56, 58, 60, 62, 64]
    + [66, 68, 70, 72, 74, 76, 78, 80, 82, 84, 86, 88], dtype=np.int32)

# tc table (qp 0..65): HEVC values through 53, pattern continuation [verify]
TC_TABLE = np.array(
    [0] * 18
    + [1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 5, 5,
       6, 6, 7, 8, 9, 10, 11, 13, 14, 16, 18, 20, 22, 24]
    + [26, 28, 31, 34, 37, 40, 44, 48, 52, 57, 62, 68], dtype=np.int32)


def _edge_maps(leaves, h: int, w: int, grid: int, scale: int):
    """Boolean maps of CU boundaries on the filter grid.

    ev[y, k]: vertical edge at x = (k+1)*grid, sample row y
    eh[k, x]: horizontal edge at y = (k+1)*grid, sample column x
    (plane coordinates; `scale` shifts luma leaf coords to this plane).
    """
    nv = w // grid - (0 if w % grid else 1)
    nh = h // grid - (0 if h % grid else 1)
    ev = np.zeros((h, max(nv, 0)), dtype=bool)
    eh = np.zeros((max(nh, 0), w), dtype=bool)
    for leaf in leaves:
        x0, y0 = leaf.x0 >> scale, leaf.y0 >> scale
        bw, bh = leaf.w >> scale, leaf.h >> scale
        if x0 > 0 and x0 % grid == 0:
            ev[y0:y0 + bh, x0 // grid - 1] = True
        if y0 > 0 and y0 % grid == 0:
            eh[y0 // grid - 1, x0:x0 + bw] = True
    return ev, eh


def _edge_bs(intra, cbf, mv, ref, p_u, q_u):
    """BS per edge position from the 4×4 unit indices on each side
    (reference: xGetBoundaryStrengthSingle): 2 if either side intra; 1 on
    cbf, ref mismatch, or >= half-pel MV delta; else 0."""
    bs = np.zeros(p_u[0].shape, dtype=np.int8)
    i2 = intra[p_u] | intra[q_u]
    c1 = cbf[p_u] | cbf[q_u]
    rdiff = (ref[p_u] != ref[q_u]).any(axis=-1)
    mdiff = (np.abs(mv[p_u].astype(np.int64) - mv[q_u]) >= 2).any(axis=(-2, -1))
    bs[c1 | rdiff | mdiff] = 1
    bs[i2] = 2
    return bs


def _bs_maps(leaves, w4: int, h4: int):
    """Per-4×4 boundary-strength inputs (reference: the MotionBuf +
    cbf/pred maps xGetBoundaryStrengthSingle consults): intra, cbf_y,
    per-list mv (qpel) and ref idx (-1 unused)."""
    from vvc_torch.kernels.affine import affine_mv_grid
    intra = np.ones((h4, w4), dtype=bool)
    cbf = np.zeros((h4, w4), dtype=bool)
    mv = np.zeros((h4, w4, 2, 2), dtype=np.int32)
    ref = np.full((h4, w4, 2), -1, dtype=np.int8)
    for l in leaves:
        sl = (slice(l.y0 >> 2, (l.y0 + l.h) >> 2),
              slice(l.x0 >> 2, (l.x0 + l.w) >> 2))
        intra[sl] = l.pred == 0
        cbf[sl] = bool(l.cbf_y)
        if l.pred == 1:
            for li in range(2):
                if (l.inter_dir >> li) & 1:
                    if l.affine:
                        mv[sl + (li,)] = affine_mv_grid(l.w, l.h,
                                                        l.cpmv[li],
                                                        l.affine)
                    else:
                        mv[sl + (li,)] = np.asarray(l.mv[li])
                    ref[sl + (li,)] = l.ref_idx[li]
    return intra, cbf, mv, ref


def _filter_luma_edges_v(plane, ev, grid, beta, tc_tab, maxv, bs_ctx=None):
    """Filter all vertical luma edges in place — batched over ALL edge
    columns at once (at grid 8 the ±4-tap neighbourhoods of adjacent edges
    never overlap, so the batch equals the sequential left-to-right loop).

    tc_tab: (qp_idx, bit_depth) → per-SEGMENT tc derives from the segment
    BS (tc row qp+2 at BS 2, qp at BS 1 — HEVC/VVC idx = qp + 2(BS-1));
    bs_ctx: (intra, cbf, mv, ref) maps or None (BS=2 everywhere, the
    intra-slice fast path)."""
    h, nv = ev.shape
    ks = np.flatnonzero(ev.any(axis=0))
    if ks.size == 0:
        return
    xs = (ks + 1) * grid                              # [E]
    cols = xs[None, :] + np.arange(-4, 4)[:, None]    # [8, E]
    seg = plane[:, cols]                              # [h, 8, E]
    p3, p2, p1, p0 = seg[:, 0], seg[:, 1], seg[:, 2], seg[:, 3]
    q0, q1, q2, q3 = seg[:, 4], seg[:, 5], seg[:, 6], seg[:, 7]
    rows = ev[:, ks]                                  # [h, E]
    g = h // 4
    qpi, bd = tc_tab
    if bs_ctx is None:
        bs_seg = np.full((g, len(ks)), 2, dtype=np.int8)
    else:
        intra, cbf, mv, ref = bs_ctx
        yy = (np.arange(g) * 4)[:, None] >> 2          # [g,1] unit rows
        pq = xs[None, :] >> 2                          # [1,E] q-side units
        pp = (xs[None, :] - 1) >> 2
        p_u = (np.broadcast_to(yy, (g, len(ks))),
               np.broadcast_to(pp, (g, len(ks))))
        q_u = (np.broadcast_to(yy, (g, len(ks))),
               np.broadcast_to(pq, (g, len(ks))))
        bs_seg = _edge_bs(intra, cbf, mv, ref, p_u, q_u)
    tc = (TC_TABLE[np.minimum(qpi + 2 * (np.maximum(
        bs_seg.astype(np.int32), 1) - 1), 65)]
        << (bd - 8)).astype(np.int32)                  # [g,E] per segment
    # segment decisions on 4-row groups using rows 0 and 3
    dp = np.abs(p2 - 2 * p1 + p0)
    dq = np.abs(q2 - 2 * q1 + q0)
    dp0, dp3 = dp[0::4][:g], dp[3::4][:g]
    dq0, dq3 = dq[0::4][:g], dq[3::4][:g]
    d = dp0 + dp3 + dq0 + dq3
    seg_on = (d < beta) & rows[0::4][:g] & (bs_seg > 0)
    thr = (5 * tc + 1) >> 1
    strong = (seg_on
              & (2 * (dp0 + dq0) < (beta >> 2))
              & (2 * (dp3 + dq3) < (beta >> 2))
              & (np.abs(p3[0::4][:g] - p0[0::4][:g])
                 + np.abs(q0[0::4][:g] - q3[0::4][:g]) < (beta >> 3))
              & (np.abs(p0[0::4][:g] - q0[0::4][:g]) < thr)
              & (np.abs(p3[3::4][:g] - p0[3::4][:g])
                 + np.abs(q0[3::4][:g] - q3[3::4][:g]) < (beta >> 3))
              & (np.abs(p0[3::4][:g] - q0[3::4][:g]) < thr))
    on = np.repeat(seg_on, 4, axis=0)[:h]
    st = np.repeat(strong, 4, axis=0)[:h]
    nr = on & ~st
    tc = np.repeat(tc, 4, axis=0)[:h]                  # [h,E] per sample
    c2 = 2 * tc
    sp0 = np.clip((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3, p0 - c2, p0 + c2)
    sp1 = np.clip((p2 + p1 + p0 + q0 + 2) >> 2, p1 - c2, p1 + c2)
    sp2 = np.clip((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3, p2 - c2, p2 + c2)
    sq0 = np.clip((p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3, q0 - c2, q0 + c2)
    sq1 = np.clip((p0 + q0 + q1 + q2 + 2) >> 2, q1 - c2, q1 + c2)
    sq2 = np.clip((p0 + q0 + q1 + 3 * q2 + 2 * q3 + 4) >> 3, q2 - c2, q2 + c2)
    delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4
    n_on = nr & (np.abs(delta) < 10 * tc)
    dlt = np.clip(delta, -tc, tc)
    np0 = np.clip(p0 + dlt, 0, maxv)
    nq0 = np.clip(q0 - dlt, 0, maxv)
    act = (beta + (beta >> 1)) >> 3
    side_p = np.repeat((dp0 + dp3) < act, 4, axis=0)[:h] & n_on
    side_q = np.repeat((dq0 + dq3) < act, 4, axis=0)[:h] & n_on
    tch = tc >> 1
    dp1v = np.clip((((p2 + p0 + 1) >> 1) - p1 + dlt) >> 1, -tch, tch)
    dq1v = np.clip((((q2 + q0 + 1) >> 1) - q1 - dlt) >> 1, -tch, tch)
    np1 = np.clip(p1 + dp1v, 0, maxv)
    nq1 = np.clip(q1 + dq1v, 0, maxv)

    plane[:, xs - 1] = np.where(st, np.clip(sp0, 0, maxv),
                                np.where(n_on, np0, p0))
    plane[:, xs - 2] = np.where(st, np.clip(sp1, 0, maxv),
                                np.where(side_p, np1, p1))
    plane[:, xs - 3] = np.where(st, np.clip(sp2, 0, maxv), p2)
    plane[:, xs + 0] = np.where(st, np.clip(sq0, 0, maxv),
                                np.where(n_on, nq0, q0))
    plane[:, xs + 1] = np.where(st, np.clip(sq1, 0, maxv),
                                np.where(side_q, nq1, q1))
    plane[:, xs + 2] = np.where(st, np.clip(sq2, 0, maxv), q2)


def _filter_chroma_edges_v(plane, ev, grid, tc, maxv, intra_map=None):
    """Chroma weak filter; filtered only at BS=2 edges (either side intra
    — reference: chroma deblocking gated on bS==2)."""
    h, nv = ev.shape
    ks = np.flatnonzero(ev.any(axis=0))
    if ks.size == 0:
        return
    xs = (ks + 1) * grid
    rows = ev[:, ks]
    if intra_map is not None:
        yy = (np.arange(h) * 2)[:, None] >> 2
        pu = ((xs * 2 - 1)[None, :] >> 2)
        qu = ((xs * 2)[None, :] >> 2)
        bs2 = intra_map[yy, pu] | intra_map[yy, qu]
        rows = rows & bs2
    p1 = plane[:, xs - 2]
    p0 = plane[:, xs - 1]
    q0 = plane[:, xs]
    q1 = plane[:, xs + 1]
    delta = np.clip((((q0 - p0) * 4) + p1 - q1 + 4) >> 3, -tc, tc)
    plane[:, xs - 1] = np.where(rows, np.clip(p0 + delta, 0, maxv), p0)
    plane[:, xs] = np.where(rows, np.clip(q0 - delta, 0, maxv), q0)


def deblock_frame(recon_planes, leaves, qp: int, bit_depth: int = 8,
                  tile_x_bounds=(), tile_y_bounds=()):
    """Deblock one picture in place (vertical pass then horizontal pass,
    reference order loopFilterPic: DEBLOCK_VER then DEBLOCK_HOR).

    tile_x_bounds: luma x positions of vertical tile boundaries — edges
    there are skipped (pps_loop_filter_across_tiles_enabled_flag = 0, the
    shard-friendly normative configuration, SURVEY.md §5.7)."""
    y, cb, cr = recon_planes
    h, w = y.shape
    maxv = (1 << bit_depth) - 1
    qpi = int(np.clip(qp, 0, 63))
    beta = int(BETA_TABLE[qpi]) << (bit_depth - 8)
    tc2 = int(TC_TABLE[min(qpi + 2, 65)]) << (bit_depth - 8)  # BS=2 tc
    tc_tab = (qpi, bit_depth)

    # BS inputs: skip the map build on all-intra frames (BS=2 everywhere)
    any_inter = any(l.pred == 1 for l in leaves)
    bs_ctx = None
    intra_map = None
    if any_inter:
        intra_map, cbf_m, mv_m, ref_m = _bs_maps(leaves, (w + 3) >> 2,
                                                 (h + 3) >> 2)
        bs_ctx = (intra_map, cbf_m, mv_m, ref_m)

    ev, eh = _edge_maps(leaves, h, w, 8, 0)
    for bx in tile_x_bounds:
        if bx % 8 == 0 and 0 < bx < w:
            ev[:, bx // 8 - 1] = False
    for by in tile_y_bounds:
        if by % 8 == 0 and 0 < by < h:
            eh[by // 8 - 1, :] = False
    _filter_luma_edges_v(y, ev, 8, beta, tc_tab, maxv, bs_ctx)
    # horizontal pass = vertical pass on the transpose (BS maps transpose
    # with it; MV components swap but only |delta| magnitudes are compared)
    yt = np.ascontiguousarray(y.T)
    bs_ctx_t = None
    if bs_ctx is not None:
        bs_ctx_t = (intra_map.T, cbf_m.T, mv_m.transpose(1, 0, 2, 3),
                    ref_m.transpose(1, 0, 2))
    _filter_luma_edges_v(yt, eh.T, 8, beta, tc_tab, maxv, bs_ctx_t)
    y[:] = yt.T

    ch, cw = cb.shape
    evc, ehc = _edge_maps(leaves, ch, cw, 8, 1)
    for bx in tile_x_bounds:
        cbx = bx >> 1
        if cbx % 8 == 0 and 0 < cbx < cw:
            evc[:, cbx // 8 - 1] = False
    for by in tile_y_bounds:
        cby = by >> 1
        if cby % 8 == 0 and 0 < cby < ch:
            ehc[cby // 8 - 1, :] = False
    for pl in (cb, cr):
        _filter_chroma_edges_v(pl, evc, 8, tc2, maxv, intra_map)
        plt = np.ascontiguousarray(pl.T)
        _filter_chroma_edges_v(plt, ehc.T, 8, tc2, maxv,
                               None if intra_map is None else intra_map.T)
        pl[:] = plt.T

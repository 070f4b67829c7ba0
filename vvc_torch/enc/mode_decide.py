"""Encoder mode-decision pass: merge matching + CIIP/GPM/BCW/MRL picks.

TPU-native analog of the reference's merge-mode RD checks
(`VTM/source/Lib/EncoderLib/EncCu.cpp` →
xCheckRDCostMerge2Nx2N / xCheckRDCostMergeGeo; InterSearch BCW loop;
IntraSearch multiRefIdx loop).  VERDICT r3 task 5: these decisions used
to run inside `reconstruct_leaves` (per-leaf Python on the serial hot
path); here they run ONCE per tile as a dedicated pass, so reconstruction
becomes pure execution (native-core eligible) and the syntax writer
serializes precomputed values instead of re-deriving candidate lists.

The pass walks leaves in z-order evolving a MotionState exactly like the
syntax writer/reader (same merge/AMVP derivations on identical state →
the decoder reconstructs the same lists).  Intra-prediction inputs for
decisions (CIIP planar, MRL lines) use ORIGINAL-sample neighbours — the
same approximation the batched RDO search uses; reconstruction then
executes the chosen mode exactly, so bit-exactness is unaffected.

Returns a per-leaf prediction cache so reconstruction does not repeat
the motion compensation (the single biggest per-leaf host cost).
"""
from __future__ import annotations

import numpy as np

from vvc_torch.kernels.intra import build_ref_line, build_ref_line_mrl, predict_intra
from vvc_torch.model.motion import (MotionState, amvp_candidates, match_merge,
                              merge_candidates, temporal_candidate)

# MMVD offset tables (reference: CommonDef.h; shared with the syntax coder)
MMVD_DISTS = (1, 2, 4, 8, 16, 32, 64, 128)
MMVD_DIRS = ((1, 0), (-1, 0), (0, 1), (0, -1))


def mmvd_apply(cand, dist_idx: int, dir_idx: int):
    """Merge candidate + MMVD offset → (inter_dir, mv, ref).  The offset
    applies to every used list (simplified vs the spec's POC-scaled L1
    offset [verify]; both codec halves share this)."""
    d, mv, ref = cand
    ox = MMVD_DISTS[dist_idx] * MMVD_DIRS[dir_idx][0]
    oy = MMVD_DISTS[dist_idx] * MMVD_DIRS[dir_idx][1]
    out = [[int(mv[0][0]), int(mv[0][1])], [int(mv[1][0]), int(mv[1][1])]]
    for l in (0, 1):
        if (d >> l) & 1:
            out[l][0] += ox
            out[l][1] += oy
    return d, out, ref


def match_mmvd(leaf, cands):
    """(base_cand, dist_idx, dir_idx) expressing the leaf's motion as
    merge-base + MMVD offset, else None (reference:
    EncCu::xCheckRDCostMerge MMVD loop)."""
    for ci in range(min(2, len(cands))):
        d, mv, ref = cands[ci]
        if d != leaf.inter_dir:
            continue
        if any(((d >> l) & 1) and int(ref[l]) != leaf.ref_idx[l]
               for l in (0, 1)):
            continue
        l0 = 0 if d & 1 else 1
        dx = leaf.mv[l0][0] - int(mv[l0][0])
        dy = leaf.mv[l0][1] - int(mv[l0][1])
        if (dx != 0) == (dy != 0):          # exactly one axis
            continue
        mag = abs(dx) if dx else abs(dy)
        if mag not in MMVD_DISTS:
            continue
        di = MMVD_DISTS.index(mag)
        gi = MMVD_DIRS.index((1 if dx > 0 else (-1 if dx < 0 else 0),
                              1 if dy > 0 else (-1 if dy < 0 else 0)))
        _, applied, _ = mmvd_apply(cands[ci], di, gi)
        ok = all(not ((d >> l) & 1)
                 or (applied[l][0] == leaf.mv[l][0]
                     and applied[l][1] == leaf.mv[l][1])
                 for l in (0, 1))
        if ok:
            return ci, di, gi
    return None


def smvd_refs(cur_poc: int, ref_pocs):
    """Symmetric-MVD reference pair: nearest past ref in L0 and nearest
    future ref in L1, or None (reference: Slice::setBiDirPred)."""
    l0, l1 = ref_pocs
    past = [(cur_poc - p, i) for i, p in enumerate(l0) if p < cur_poc]
    fut = [(p - cur_poc, i) for i, p in enumerate(l1) if p > cur_poc]
    if not past or not fut:
        return None
    return (min(past)[1], min(fut)[1])


def _amvp_plan(ms, leaf, x0, y0, size):
    """Per-used-list (list, mvp_idx, dx, dy) for a translational AMVP CU."""
    plan = []
    for l in (0, 1):
        if not (leaf.inter_dir >> l) & 1:
            continue
        mvp = amvp_candidates(ms, x0, y0, size, l, leaf.ref_idx[l])
        mv = leaf.mv[l]
        costs = [abs(mv[0] - p[0]) + abs(mv[1] - p[1]) for p in mvp]
        pi = int(np.argmin(costs))
        plan.append((l, pi, mv[0] - mvp[pi][0], mv[1] - mvp[pi][1]))
    return plan


def _affine_plan(ms, leaf, x0, y0, size):
    """Per-used-list (list, mvp_idx, ((dx,dy), ...)) for an affine CU
    (CPMV MVDs vs one shared translational predictor — simplified affine
    AMVP; reference: PU::fillAffineMvpCand)."""
    plan = []
    ncp = 2 if leaf.affine == 4 else 3
    for l in (0, 1):
        if not (leaf.inter_dir >> l) & 1:
            continue
        mvp = amvp_candidates(ms, x0, y0, size, l, leaf.ref_idx[l])
        cp = leaf.cpmv[l]
        costs = [sum(abs(cp[c][0] - p[0]) + abs(cp[c][1] - p[1])
                     for c in range(ncp)) for p in mvp]
        pi = int(np.argmin(costs))
        plan.append((l, pi, tuple((cp[c][0] - mvp[pi][0],
                                   cp[c][1] - mvp[pi][1])
                                  for c in range(ncp))))
    return plan


def decide_modes(leaves, orig_planes, qp: int, bit_depth: int, sps,
                 inter_cfg=None, refs=None):
    """Mode decisions for one tile's leaves (z-order), in place.

    Sets per-leaf: ciip, gpm(+gpm_mv, motion rewrite), bcw, mrl, and the
    precomputed syntax values merge_match / mmvd / amvp / smvd / imv
    (leaf.decided = True).  Returns {leaf_index: (pred_y, pred_cb,
    pred_cr)} — inter predictions for reconstruction to consume (CIIP
    leaves carry the un-blended inter part; recon adds the planar blend
    against real reconstructed neighbours)."""
    o_y, o_cb, o_cr = orig_planes
    h, w = o_y.shape
    has_inter = any(l.pred == 1 for l in leaves)
    mrl_on = getattr(sps, "mrl", False)
    cfg = inter_cfg or {}
    preds = {}
    if not has_inter and not mrl_on:
        for l in leaves:
            l.decided = True
        return preds
    refs_l0, refs_l1 = refs if refs is not None else ([], [])
    ciip_on = bool(cfg.get("ciip"))
    gpm_on = bool(cfg.get("gpm")) and bool(cfg.get("is_b"))
    bcw_on = bool(cfg.get("bcw"))
    mmvd_on = getattr(sps, "mmvd", False)
    is_b = bool(cfg.get("is_b", False))
    n_ref = cfg.get("n_ref", (0, 0))
    cur_poc = cfg.get("cur_poc", 0)
    ref_pocs = cfg.get("ref_pocs", ((), ()))
    col = cfg.get("col")
    ms = MotionState(w, h)
    # orig-neighbour approximation: every unit "available" for ref lines
    all_y = np.ones(((h + 3) >> 2, (w + 3) >> 2), dtype=bool)

    pre = {}
    if has_inter:
        from vvc_torch.kernels.mc import batch_inter_preds
        pre = batch_inter_preds(leaves, refs_l0, refs_l1, bit_depth, cfg)

    from vvc_torch.kernels.mc import (BCW_W1, bcw_pred_leaf, gpm_uni_pred,
                                inter_pred_leaf, mc_block_np)

    for li, leaf in enumerate(leaves):
        lw, lh = leaf.w, leaf.h
        x0, y0 = leaf.x0, leaf.y0
        if leaf.pred == 1:
            if li in pre:
                pred_y, pred_cb, pred_cr = pre[li]
            else:
                pred_y = inter_pred_leaf(leaf, 0, refs_l0, refs_l1,
                                         bit_depth, cfg)
                pred_cb = inter_pred_leaf(leaf, 1, refs_l0, refs_l1,
                                          bit_depth, cfg)
                pred_cr = inter_pred_leaf(leaf, 2, refs_l0, refs_l1,
                                          bit_depth, cfg)
            tgt = o_y[y0:y0 + lh, x0:x0 + lw].astype(np.int64)
            cands = midx = None
            if not leaf.affine and lw == lh:
                tmvp = temporal_candidate(col, x0, y0, lw, cur_poc,
                                          ref_pocs, is_b)
                cands = merge_candidates(ms, x0, y0, lw, is_b, *n_ref,
                                         tmvp=tmvp)
                midx = match_merge(leaf, cands)
            # CIIP (reference: EncCu CIIP RD inside merge check): merge
            # motion + planar intra, equal-weight blend; decision planar
            # uses original neighbours, recon blends against real recon
            if (ciip_on and not leaf.affine and lw == lh
                    and 64 <= lw * lw and lw < 128 and midx is not None):
                c = build_ref_line(o_y, all_y, x0, y0, lw, bit_depth)
                pl = predict_intra(c, 0, lw, bit_depth)
                blend = (pred_y + pl + 1) >> 1
                if (((tgt - blend) ** 2).sum()
                        < ((tgt - pred_y) ** 2).sum()):
                    leaf.ciip = True
            # GPM (reference: EncCu::xCheckRDCostMergeGeo): competes
            # against the current best (incl. a CIIP blend)
            if (gpm_on and not leaf.affine and lw == lh
                    and 8 <= lw <= 64):
                from vvc_torch.kernels.gpm import (gpm_blend, gpm_mask,
                                             gpm_mask_chroma,
                                             gpm_uni_candidates)
                uni = gpm_uni_candidates(cands)
                pool, seen_u = [], set()
                for ui, cd in enumerate(uni):
                    if cd is None or cd in seen_u:
                        continue
                    seen_u.add(cd)
                    pool.append((ui, cd))
                    if len(pool) == 3:
                        break
                if len(pool) >= 2:
                    base_y = pred_y
                    if leaf.ciip:
                        c = build_ref_line(o_y, all_y, x0, y0, lw, bit_depth)
                        pl = predict_intra(c, 0, lw, bit_depth)
                        base_y = (pred_y + pl + 1) >> 1
                    base_sse = int(((tgt - base_y) ** 2).sum())
                    upred = {ui: gpm_uni_pred(cd, 0, x0, y0, lw, lh,
                                              refs_l0, refs_l1, bit_depth)
                             for ui, cd in pool}
                    # mode subset: every other angle at distance 0, every
                    # 4th at distance 2 — swept as one [M,h,w] batch
                    modes_try = (list(range(0, 64, 8))
                                 + [m + 2 for m in range(0, 64, 16)])
                    masks = np.stack([gpm_mask(lw, lh, gm)
                                      for gm in modes_try])    # [M,h,w]
                    best = None
                    for i0, c0 in pool:
                        p0 = upred[i0].astype(np.int64)
                        for i1, c1 in pool:
                            if i1 == i0:
                                continue
                            p1 = upred[i1].astype(np.int64)
                            bl = (p0[None] * masks
                                  + p1[None] * (8 - masks) + 4) >> 3
                            sse = ((tgt[None] - bl) ** 2).sum(axis=(1, 2))
                            mi = int(np.argmin(sse))
                            if best is None or sse[mi] < best[0]:
                                best = (int(sse[mi]), modes_try[mi],
                                        i0, i1, c0, c1)
                    # adopt only past a per-sample margin (GPM costs ~10
                    # more bins than a bare merge_idx)
                    if best is not None and best[0] + lw * lh < base_sse:
                        _, gm, i0, i1, c0, c1 = best
                        leaf.ciip = False
                        leaf.gpm = (gm, i0, i1)
                        leaf.gpm_mv = (c0, c1)
                        lst, pmv, prf = c0
                        mvt = [(0, 0), (0, 0)]
                        rft = [0, 0]
                        mvt[lst] = (pmv[0], pmv[1])
                        rft[lst] = prf
                        leaf.inter_dir = 1 << lst
                        leaf.mv = tuple(mvt)
                        leaf.ref_idx = tuple(rft)
                        cwgt = gpm_mask_chroma(lw >> 1, lh >> 1, gm)
                        pred_y = gpm_blend(upred[i0], upred[i1],
                                           gpm_mask(lw, lh, gm))
                        pred_cb = gpm_blend(
                            gpm_uni_pred(c0, 1, x0, y0, lw, lh, refs_l0,
                                         refs_l1, bit_depth),
                            gpm_uni_pred(c1, 1, x0, y0, lw, lh, refs_l0,
                                         refs_l1, bit_depth), cwgt)
                        pred_cr = gpm_blend(
                            gpm_uni_pred(c0, 2, x0, y0, lw, lh, refs_l0,
                                         refs_l1, bit_depth),
                            gpm_uni_pred(c1, 2, x0, y0, lw, lh, refs_l0,
                                         refs_l1, bit_depth), cwgt)
                        midx = None
            # BCW (reference: InterSearch xEstimateInterResidual BCW
            # loop).  AMVP-only (merge inheritance not implemented), so
            # the margin charges the mvd-coding cost.
            if (bcw_on and leaf.inter_dir == 3 and not leaf.affine
                    and leaf.gpm is None and not leaf.ciip):
                p0b = mc_block_np(refs_l0[leaf.ref_idx[0]][0], x0, y0,
                                  lw, lh, leaf.mv[0][0], leaf.mv[0][1],
                                  bit_depth).astype(np.int64)
                p1b = mc_block_np(refs_l1[leaf.ref_idx[1]][0], x0, y0,
                                  lw, lh, leaf.mv[1][0], leaf.mv[1][1],
                                  bit_depth).astype(np.int64)
                base_sse = int(((tgt - pred_y) ** 2).sum())
                best_w = None
                for wi in (0, 1, 3, 4):
                    w1_ = BCW_W1[wi]
                    bl = np.clip((p0b * (8 - w1_) + p1b * w1_ + 4) >> 3,
                                 0, (1 << bit_depth) - 1)
                    sse = int(((tgt - bl) ** 2).sum())
                    if best_w is None or sse < best_w[0]:
                        best_w = (sse, wi)
                if best_w is not None and best_w[0] + 2 * lw * lh < base_sse:
                    leaf.bcw = best_w[1]
                    midx = None    # non-default weight forces AMVP path
                    pred_y = bcw_pred_leaf(leaf, 0, refs_l0, refs_l1,
                                           bit_depth)
                    pred_cb = bcw_pred_leaf(leaf, 1, refs_l0, refs_l1,
                                            bit_depth)
                    pred_cr = bcw_pred_leaf(leaf, 2, refs_l0, refs_l1,
                                            bit_depth)
            # precompute the syntax values the writer needs
            is_gpm = leaf.gpm is not None
            leaf.merge_match = midx if (not is_gpm and leaf.bcw == 2) else None
            leaf.mmvd = None
            if (leaf.merge_match is None and not is_gpm and not leaf.affine
                    and leaf.bcw == 2 and mmvd_on and cands is not None):
                leaf.mmvd = match_mmvd(leaf, cands)
            if (leaf.merge_match is None and leaf.mmvd is None
                    and not is_gpm):
                if leaf.affine:
                    leaf.amvp = tuple(_affine_plan(ms, leaf, x0, y0, lw))
                else:
                    plan = _amvp_plan(ms, leaf, x0, y0, lw)
                    leaf.amvp = tuple(plan)
                    sref = (smvd_refs(cur_poc, ref_pocs)
                            if getattr(sps, "smvd", False) else None)
                    leaf.smvd = bool(
                        sref is not None and len(plan) == 2
                        and sref == (leaf.ref_idx[0], leaf.ref_idx[1])
                        and plan[0][2] == -plan[1][2]
                        and plan[0][3] == -plan[1][3]
                        and (plan[0][2] or plan[0][3]))
                    comps = [c for (_, _, dx, dy) in plan for c in (dx, dy)]
                    if getattr(sps, "amvr", False) and any(comps):
                        # engage a coarser MVD tier only when the EG1-bin
                        # saving on the rescaled MVDs beats the 1-2 IMV
                        # flag bins (pure write-time decision; prevents
                        # flag overhead on near-zero MVDs)
                        def _bins(vals):
                            t = 0
                            for c in vals:
                                a = abs(c)
                                t += 1 + (a > 0) + (a > 1)
                                if a > 1:
                                    t += 2 * max(0, (a - 2)
                                                 .bit_length() - 1) + 2
                            return t
                        base_bits = _bins(comps)
                        if all(c % 16 == 0 for c in comps):
                            if _bins([c >> 4 for c in comps]) + 2 < base_bits:
                                leaf.imv = 2
                        elif all(c % 4 == 0 for c in comps):
                            if _bins([c >> 2 for c in comps]) + 2 < base_bits:
                                leaf.imv = 1
            preds[li] = (pred_y, pred_cb, pred_cr)
            # evolve the mirrored motion state exactly like writer/reader
            if leaf.affine:
                ms.set_inter_affine(x0, y0, lw, lh, leaf.inter_dir,
                                    leaf.cpmv, leaf.ref_idx, leaf.affine)
            else:
                ms.set_inter(x0, y0, lw, leaf.inter_dir, leaf.mv,
                             leaf.ref_idx)
        else:
            # MRL (reference: IntraSearch multiRefIdx loop): pick the
            # reference line {0,1,2} by prediction SSE on original
            # neighbours, with a per-sample margin for the extra bins
            if (mrl_on and not getattr(sps, "lossless", False)
                    and lw == lh and leaf.luma_mode < 67 and not leaf.isp
                    and (y0 % sps.ctu_size) > 0):
                tgt_m = o_y[y0:y0 + lh, x0:x0 + lw].astype(np.int64)
                best_m = None
                for k_ in (0, 1, 2):
                    if k_ == 0:
                        c_ = build_ref_line(o_y, all_y, x0, y0, lw,
                                            bit_depth)
                    else:
                        c_ = build_ref_line_mrl(o_y, all_y, x0, y0, lw,
                                                bit_depth, k_)
                    p_ = predict_intra(c_, leaf.luma_mode, lw, bit_depth)
                    sse_ = int(((tgt_m - p_) ** 2).sum()) + (lw if k_ else 0)
                    if best_m is None or sse_ < best_m[0]:
                        best_m = (sse_, k_)
                leaf.mrl = best_m[1]
            if lw == lh:
                ms.set_intra(x0, y0, lw)
            else:
                ms.set_intra(x0, y0, 4)  # rect intra: mark origin unit only
        leaf.decided = True
    return preds

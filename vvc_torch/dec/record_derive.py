"""Leaf derivation from native-parser records (decoder).

Copy of vvc/dec/record_derive.py with its imports rewritten.

The native tree reader (vvc_torch/packer/cabac_core.cpp tr_read) parses CU
syntax without any motion derivation — VVC parsing is decoupled from
derivation by design (OpenVVC's vcl_*.c / drv_*.c split, SURVEY §2.6).
This module is the `drv` half: it walks the flat records in coding order,
derives merge/AMVP candidate lists against the running MotionState, and
builds the same Leaf objects vvc_torch.cabac.cu_syntax.TreeReader produces
(bit-identical reconstruction; enforced by tests/test_torch_dec.py).
"""
from __future__ import annotations

import numpy as np

from vvc_torch.model.frame import Leaf
from vvc_torch.model.motion import (merge_candidates, amvp_candidates,
                                    temporal_candidate)

# record field indices — keep in sync with TrRec in cabac_core.cpp
(RX0, RY0, RW, RH, RKIND, RSKIP, RMERGE, RMERGE_IDX,
 RMMVD, RMMVD_CI, RMMVD_DI, RMMVD_GI,
 RGPM, RGPM_GM, RGPM_I0, RGPM_I1, RCIIP,
 RDIR, RAFFINE, RSMVD, RIMV, RBCW,
 RREF0, RREF1, RMVP0, RMVP1,
 RMVD0X, RMVD0Y, RMVD1X, RMVD1Y) = range(30)
RCP0 = 30
RMODE, RMIP, RMRL, RISP, RCHROMA, RMTS, RLFNST, RBDPCM = range(42, 50)
RCBF_Y, RCBF_CB, RCBF_CR, ROFF_Y, ROFF_CB, ROFF_CR = range(50, 56)

MMVD_DISTS = (1, 2, 4, 8, 16, 32, 64, 128)
MMVD_DIRS = ((1, 0), (-1, 0), (0, 1), (0, -1))


def _levels(levels, off, w, h):
    if off < 0:
        return None
    return levels[off:off + w * h].reshape(h, w).copy()


def derive_leaves(recs: np.ndarray, levels: np.ndarray, state, mstate,
                  slice_type: int, n_ref, max_merge: int, col, cur_poc: int,
                  ref_pocs, smvd_refs, ctu_size: int) -> list:
    """records [N, TR_NREC] → Leaf list, updating state/mstate in coding
    order (mirror of TreeReader leaf construction + _mark_inter)."""
    from vvc_torch.model.partition import node_depth
    from vvc_torch.common.types import PLANAR_IDX
    is_b = slice_type == 0
    inter_slice = slice_type != 2
    out = []
    for r in recs:
        x0, y0, w, h = int(r[RX0]), int(r[RY0]), int(r[RW]), int(r[RH])
        if r[RKIND] == 0:
            leaf = Leaf(x0, y0, w, h, int(r[RMODE]), isp=int(r[RISP]),
                        chroma_mode=int(r[RCHROMA]), mrl=int(r[RMRL]),
                        mts=int(r[RMTS]), lfnst=int(r[RLFNST]))
            _attach_levels(leaf, r, levels, w, h)
            d = node_depth(ctu_size, w, h)
            if state is not None:
                state.set_cu(x0, y0, w,
                             PLANAR_IDX if r[RMIP] else int(r[RMODE]),
                             d, h=h)
                state.mark_coded(x0, y0, w, h=h)
            if inter_slice:
                mstate.set_intra(x0, y0, w)
            out.append(leaf)
            continue
        size = w
        skip = bool(r[RSKIP])
        if r[RMERGE]:
            tmvp = temporal_candidate(col, x0, y0, size, cur_poc,
                                      ref_pocs, is_b)
            cands = merge_candidates(mstate, x0, y0, size, is_b,
                                     n_ref[0], n_ref[1], max_merge,
                                     tmvp=tmvp)
            if r[RGPM]:
                from vvc_torch.kernels.gpm import gpm_uni_candidates
                uni = gpm_uni_candidates(cands)
                i0, i1 = int(r[RGPM_I0]), int(r[RGPM_I1])
                if (i0 >= len(uni) or i1 >= len(uni)
                        or uni[i0] is None or uni[i1] is None):
                    raise ValueError(
                        "gpm merge idx out of candidate range "
                        "(corrupt stream)")
                c0, c1 = uni[i0], uni[i1]
                lst, pmv, prf = c0
                mvt = [(0, 0), (0, 0)]
                rft = [0, 0]
                mvt[lst] = pmv
                rft[lst] = prf
                leaf = Leaf(x0, y0, size, size, pred=1, merge=True,
                            merge_idx=i0, inter_dir=1 << lst,
                            mv=tuple(mvt), ref_idx=tuple(rft))
                leaf.gpm = (int(r[RGPM_GM]), i0, i1)
                leaf.gpm_mv = (c0, c1)
            elif r[RMMVD]:
                ci, di, gi = (int(r[RMMVD_CI]), int(r[RMMVD_DI]),
                              int(r[RMMVD_GI]))
                d_, mv, ref = cands[ci]
                ox = MMVD_DISTS[di] * MMVD_DIRS[gi][0]
                oy = MMVD_DISTS[di] * MMVD_DIRS[gi][1]
                mvo = [[int(mv[0][0]), int(mv[0][1])],
                       [int(mv[1][0]), int(mv[1][1])]]
                for l in (0, 1):
                    if (d_ >> l) & 1:
                        mvo[l][0] += ox
                        mvo[l][1] += oy
                leaf = _leaf_from_cand(x0, y0, size, (d_, mvo, ref), ci,
                                       skip=False)
            else:
                midx = int(r[RMERGE_IDX])
                leaf = _leaf_from_cand(x0, y0, size, cands[midx], midx,
                                       skip=skip)
                if r[RCIIP]:
                    leaf.ciip = True
        else:
            d_ = int(r[RDIR])
            affine = int(r[RAFFINE])
            mv = [(0, 0), (0, 0)]
            cpmv = [None, None]
            ref = [int(r[RREF0]), int(r[RREF1])]
            if affine:
                ncp = 2 if affine == 4 else 3
                for l in (0, 1):
                    if not (d_ >> l) & 1:
                        continue
                    pi = int(r[RMVP0 if l == 0 else RMVP1])
                    mvp = amvp_candidates(mstate, x0, y0, size, l, ref[l])
                    base = r[RCP0 + l * 6:RCP0 + l * 6 + 2 * ncp]
                    cpmv[l] = tuple(
                        (int(mvp[pi][0]) + int(base[2 * cp]),
                         int(mvp[pi][1]) + int(base[2 * cp + 1]))
                        for cp in range(ncp))
            else:
                smvd = bool(r[RSMVD])
                if smvd:
                    ref[0], ref[1] = smvd_refs
                sh = (0, 2, 4)[int(r[RIMV])]
                mvd0 = None
                for l in (0, 1):
                    if not (d_ >> l) & 1:
                        continue
                    pi = int(r[RMVP0 if l == 0 else RMVP1])
                    if smvd and l == 1:
                        sdx, sdy = -mvd0[0], -mvd0[1]
                    else:
                        sdx = int(r[RMVD0X if l == 0 else RMVD1X]) << sh
                        sdy = int(r[RMVD0Y if l == 0 else RMVD1Y]) << sh
                        if l == 0:
                            mvd0 = (sdx, sdy)
                    mvp = amvp_candidates(mstate, x0, y0, size, l, ref[l])
                    mv[l] = (int(mvp[pi][0]) + sdx, int(mvp[pi][1]) + sdy)
            leaf = Leaf(x0, y0, size, size, pred=1, inter_dir=d_,
                        mv=tuple(mv), ref_idx=tuple(ref), affine=affine,
                        cpmv=tuple(cpmv), bcw=int(r[RBCW]))
        _attach_levels(leaf, r, levels, w, h)
        _mark_inter(leaf, skip, mstate, state, ctu_size)
        out.append(leaf)
    return out


def _attach_levels(leaf, r, levels, w, h):
    leaf.lev_y = _levels(levels, int(r[ROFF_Y]), w, h)
    leaf.lev_cb = _levels(levels, int(r[ROFF_CB]), w >> 1, h >> 1)
    leaf.lev_cr = _levels(levels, int(r[ROFF_CR]), w >> 1, h >> 1)


def _leaf_from_cand(x0, y0, size, cand, midx, skip):
    d, mv, ref = cand
    return Leaf(x0, y0, size, size, pred=1, skip=skip, merge=True,
                merge_idx=midx, inter_dir=d,
                mv=((int(mv[0][0]), int(mv[0][1])),
                    (int(mv[1][0]), int(mv[1][1]))),
                ref_idx=(int(ref[0]) if d & 1 else 0,
                         int(ref[1]) if d & 2 else 0))


def _mark_inter(leaf, skip, mstate, state, ctu_size):
    from vvc_torch.model.partition import node_depth
    from vvc_torch.common.types import PLANAR_IDX
    if leaf.affine:
        mstate.set_inter_affine(leaf.x0, leaf.y0, leaf.w, leaf.h,
                                leaf.inter_dir, leaf.cpmv, leaf.ref_idx,
                                leaf.affine)
    else:
        mstate.set_inter(leaf.x0, leaf.y0, leaf.size, leaf.inter_dir,
                         leaf.mv, leaf.ref_idx, skip)
    d = node_depth(ctu_size, leaf.w, leaf.h)
    if state is not None:
        state.set_cu(leaf.x0, leaf.y0, leaf.size, PLANAR_IDX, d)
        state.mark_coded(leaf.x0, leaf.y0, leaf.size)

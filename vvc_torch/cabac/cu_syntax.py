"""Coding-tree and CU-level CABAC syntax — writer/reader pair.

TPU-native analog of the reference's CU syntax coding
(`VTM/source/Lib/EncoderLib/CABACWriter.cpp` →
coding_tree_unit / coding_tree / coding_unit / intra_luma_pred_modes /
intra_chroma_pred_modes; `source/Lib/DecoderLib/CABACReader.cpp` mirror;
MPM derivation: CommonLib/UnitTools.cpp → PU::getIntraMPMs; split
legality: CommonLib/UnitPartitioner.cpp).  OpenVVC counterpart:
libovvc/vcl_ctu.c, vcl_cu.c, drv_intra.c.

Round-1 scope (SURVEY.md §7.2 S2): I-slice, single tree, QT-only
partitioning (sps max MTT depth 0), one TU per CU, luma intra mode with
6-entry MPM, chroma locked to DM.  Blocks crossing the picture boundary
split implicitly without a flag (spec 7.4.11: implicit qt split).

Writer and reader share the neighbour-derivation helpers and update the
same CodingState maps, so context indices can never diverge.
"""
from __future__ import annotations

import numpy as np

from vvc_torch.common.types import PLANAR_IDX, DC_IDX, HOR_IDX, VER_IDX
from vvc_torch.model.frame import Leaf, CodingState
from vvc_torch.model.partition import (SPLIT_NONE, SPLIT_QT, SPLIT_BT_H,
                                 SPLIT_BT_V, SPLIT_TT_H, SPLIT_TT_V,
                                 allowed_splits, child_blocks, node_depth)
from vvc_torch.cabac.residual import write_residual, read_residual
from vvc_torch.utils.trace import active as _trace


def mpm_list(left_mode: int, above_mode: int):
    """6-entry MPM list, [0] always planar (reference: PU::getIntraMPMs).

    [verify] against the reference once mounted; writer/reader symmetry is
    what correctness rests on meanwhile.
    """
    def adj(m, d):
        return 2 + ((m - 2 + d) % 65)

    l = left_mode if left_mode >= 0 else PLANAR_IDX
    a = above_mode if above_mode >= 0 else PLANAR_IDX
    if l == a:
        if l > DC_IDX:
            lst = [l, adj(l, -1), adj(l, 1), adj(l, -2), adj(l, 2)]
        else:
            lst = [DC_IDX, VER_IDX, HOR_IDX, VER_IDX - 4, VER_IDX + 4]
    elif l > DC_IDX and a > DC_IDX:
        lst = [l, a]
        mx, mn = max(l, a), min(l, a)
        if mx - mn == 1:
            lst += [adj(mn, -1), adj(mx, 1), adj(mn, -2)]
        elif mx - mn >= 62:
            lst += [adj(mn, 1), adj(mx, -1), adj(mn, 2)]
        elif mx - mn == 2:
            lst += [adj(mn, 1), adj(mn, -1), adj(mx, 1)]
        else:
            lst += [adj(mn, -1), adj(mn, 1), adj(mx, -1)]
    elif l > DC_IDX or a > DC_IDX:
        m = max(l, a)
        lst = [m, adj(m, -1), adj(m, 1), adj(m, -2), adj(m, 2)]
    else:
        lst = [DC_IDX, VER_IDX, HOR_IDX, VER_IDX - 4, VER_IDX + 4]
    return [PLANAR_IDX] + lst


def _eg_write(enc, v: int, k: int):
    """Exp-Golomb order-k, bypass bins (reference: BinEncoder
    encodeRemAbsEP / xWriteEpExGolomb shape)."""
    while v >= (1 << k):
        enc.encode_bin_ep(1)
        v -= 1 << k
        k += 1
    enc.encode_bin_ep(0)
    if k:
        enc.encode_bins_ep(v, k)


def _eg_read(dec, k: int) -> int:
    v = 0
    while dec.decode_bin_ep():
        v += 1 << k
        k += 1
    if k:
        v += dec.decode_bins_ep(k)
    return v


def _tb_write(enc, x: int, n: int):
    """Truncated binary code (spec 9.3.3.7), bypass bins."""
    k = (n).bit_length() - 1
    u = (1 << (k + 1)) - n
    if x < u:
        enc.encode_bins_ep(x, k)
    else:
        enc.encode_bins_ep(x + u, k + 1)


def _tb_read(dec, n: int) -> int:
    k = (n).bit_length() - 1
    u = (1 << (k + 1)) - n
    v = dec.decode_bins_ep(k) if k else 0
    if v >= u:
        v = (v << 1) | dec.decode_bin_ep()
        v -= u
    return v


class TreeCoder:
    """Shared walking/derivation logic; subclassed by writer and reader."""

    def __init__(self, ctxs, state: CodingState, width: int, height: int,
                 ctu_size: int = 64, min_cu: int = 8, mts_enabled: bool = False,
                 cclm_enabled: bool = False, slice_type: int = 2,
                 mstate=None, n_ref=(0, 0), max_merge: int = 6,
                 col=None, cur_poc: int = 0, ref_pocs=((), ()),
                 mip_enabled: bool = False, lfnst_enabled: bool = False,
                 mtt_enabled: bool = False, isp_enabled: bool = False,
                 affine_enabled: bool = False,
                 lossless_enabled: bool = False,
                 mmvd_enabled: bool = False, ciip_enabled: bool = False,
                 gpm_enabled: bool = False, amvr_enabled: bool = False,
                 smvd_enabled: bool = False, bcw_enabled: bool = False):
        self.ctxs = ctxs
        self.state = state
        self.w = width
        self.h = height
        self.ctu = ctu_size
        self.min_cu = min_cu
        self.mts_enabled = mts_enabled
        self.cclm_enabled = cclm_enabled
        self.mip_enabled = mip_enabled
        self.lfnst_enabled = lfnst_enabled
        self.mtt_enabled = mtt_enabled
        self.isp_enabled = isp_enabled
        self.affine_enabled = affine_enabled
        self.mmvd_enabled = mmvd_enabled
        self.ciip_enabled = ciip_enabled
        self.gpm_enabled = gpm_enabled
        self.amvr_enabled = amvr_enabled
        self.smvd_enabled = smvd_enabled
        self.bcw_enabled = bcw_enabled
        # VVC-true lossless tier: transform-skip residual coding + BDPCM
        # (spec: sps_transform_skip + intra_bdpcm; replaces the r1/r2
        # transquant-bypass mechanism, which VVC removed from HEVC)
        self.lossless_enabled = lossless_enabled
        self.max_depth = (ctu_size.bit_length() - 1) - (min_cu.bit_length() - 1)
        self.slice_type = slice_type          # 0=B, 1=P, 2=I (spec values)
        self.inter_slice = slice_type != 2
        self.is_b = slice_type == 0
        self.mstate = mstate
        self.n_ref = n_ref
        self.max_merge = max_merge
        self.col = col               # ColMotion of the collocated picture
        self.cur_poc = cur_poc
        self.ref_pocs = ref_pocs

    # MMVD offset tables (reference: CommonDef.h MMVD distance/direction;
    # distances in luma 1/4-pel)
    MMVD_DISTS = (1, 2, 4, 8, 16, 32, 64, 128)
    MMVD_DIRS = ((1, 0), (-1, 0), (0, 1), (0, -1))

    def _mmvd_apply(self, cand, dist_idx: int, dir_idx: int):
        """Merge candidate + MMVD offset → (inter_dir, mv, ref).  The
        offset applies to every used list (simplified vs the spec's
        POC-scaled L1 offset [verify]; both codec halves share this)."""
        d, mv, ref = cand
        ox = self.MMVD_DISTS[dist_idx] * self.MMVD_DIRS[dir_idx][0]
        oy = self.MMVD_DISTS[dist_idx] * self.MMVD_DIRS[dir_idx][1]
        out = [[int(mv[0][0]), int(mv[0][1])],
               [int(mv[1][0]), int(mv[1][1])]]
        for l in (0, 1):
            if (d >> l) & 1:
                out[l][0] += ox
                out[l][1] += oy
        return d, out, ref

    def _merge_list(self, x0: int, y0: int, size: int):
        from vvc_torch.model.motion import merge_candidates, temporal_candidate
        tmvp = temporal_candidate(self.col, x0, y0, size, self.cur_poc,
                                  self.ref_pocs, self.is_b)
        return merge_candidates(self.mstate, x0, y0, size, self.is_b,
                                *self.n_ref, self.max_merge, tmvp=tmvp)

    def _skip_ctx(self, x0: int, y0: int) -> int:
        """cu_skip_flag ctx from left/above skip (reference:
        CABACWriter::cu_skip_flag neighbour derivation)."""
        ms = self.mstate
        c = 0
        for px, py in ((x0 - 1, y0), (x0, y0 - 1)):
            if (px >= 0 and py >= 0 and (px >> 2) < ms.w4
                    and (py >> 2) < ms.h4 and ms.skip[py >> 2, px >> 2]):
                c += 1
        return c

    def _pred_mode_ctx(self, x0: int, y0: int) -> int:
        ms = self.mstate
        for px, py in ((x0 - 1, y0), (x0, y0 - 1)):
            if (px >= 0 and py >= 0 and (px >> 2) < ms.w4
                    and (py >> 2) < ms.h4 and ms.coded[py >> 2, px >> 2]
                    and not ms.inter[py >> 2, px >> 2]):
                return 1
        return 0

    def _ciip_signaled(self, size: int) -> bool:
        # spec 7.4.11.7: ciip_flag when w*h >= 64 and w,h < 128
        return self.ciip_enabled and size * size >= 64 and size < 128

    def _smvd_refs(self):
        """Symmetric-MVD reference pair: nearest past ref in L0 and
        nearest future ref in L1, or None (reference:
        Slice::setBiDirPred sym ref derivation, spec 8.3.5)."""
        l0, l1 = self.ref_pocs
        past = [(self.cur_poc - p, i) for i, p in enumerate(l0)
                if p < self.cur_poc]
        fut = [(p - self.cur_poc, i) for i, p in enumerate(l1)
               if p > self.cur_poc]
        if not past or not fut:
            return None
        return (min(past)[1], min(fut)[1])

    def _gpm_signaled(self, size: int) -> bool:
        # spec 7.4.11.7 merge_gpm: B slice, 8 <= w,h <= 64, >= 2 merge
        # candidates (reference: CU::isGeoValid eligibility)
        return (self.gpm_enabled and self.is_b and 8 <= size <= 64
                and self.max_merge >= 2)

    def _affine_signaled(self, size: int) -> bool:
        # spec 7.4.11.5: inter_affine_flag gated on sps_affine + w,h >= 16
        return self.affine_enabled and size >= 16

    def _mark_inter(self, leaf: Leaf, skip: bool):
        if leaf.affine:
            self.mstate.set_inter_affine(leaf.x0, leaf.y0, leaf.w, leaf.h,
                                         leaf.inter_dir, leaf.cpmv,
                                         leaf.ref_idx, leaf.affine)
        else:
            self.mstate.set_inter(leaf.x0, leaf.y0, leaf.size,
                                  leaf.inter_dir, leaf.mv, leaf.ref_idx,
                                  skip)
        d = node_depth(self.ctu, leaf.w, leaf.h)
        # intra-mode plane sees inter CUs as planar (spec MPM rule)
        self.state.set_cu(leaf.x0, leaf.y0, leaf.size, PLANAR_IDX, d)
        self.state.mark_coded(leaf.x0, leaf.y0, leaf.size)

    def _mts_signaled(self, w: int, cbf_y: int, h: int | None = None) -> bool:
        # sps_explicit_mts_intra; DST7/DCT8 defined for 4..32 (spec 8.7.4)
        h = w if h is None else h
        return (self.mts_enabled and cbf_y == 1
                and 8 <= w <= 32 and 8 <= h <= 32)

    def _lfnst_signaled(self, size: int, cbf_y: int, mts: int,
                        pred: int, h: int | None = None) -> bool:
        # intra luma, primary DCT2 only, square, size >= 8 (reference:
        # CABACWriter/Reader::residual_lfnst_mode conditions)
        from vvc_torch.kernels.lfnst import lfnst_allowed
        if h is not None and h != size:
            return False
        return (self.lfnst_enabled and cbf_y == 1 and mts == 0
                and pred == 0 and lfnst_allowed(size))

    def _split_ctx(self, x0: int, y0: int, w: int, h: int) -> int:
        d = node_depth(self.ctu, w, h)
        dl = self.state.depth_at(x0 - 1, y0)
        da = self.state.depth_at(x0, y0 - 1)
        return (1 if dl > d else 0) + (1 if da > d else 0)

    def _neighbor_modes(self, x0: int, y0: int, w: int, h: int):
        left = self.state.mode_at(x0 - 1, y0 + h - 1)
        # above neighbour only within the same CTU row (line-buffer rule)
        if (y0 % self.ctu) == 0:
            above = -1
        else:
            above = self.state.mode_at(x0 + w - 1, y0 - 1)
        return left, above


class TreeWriter(TreeCoder):
    def __init__(self, enc, ctxs, state, width, height, split_map, leaf_map,
                 ctu_size=64, min_cu=8, mts_enabled=False, cclm_enabled=False,
                 **kw):
        super().__init__(ctxs, state, width, height, ctu_size, min_cu,
                         mts_enabled, cclm_enabled, **kw)
        self.enc = enc
        self.split_map = split_map    # {(x0,y0,size): bool}
        self.leaf_map = leaf_map      # {(x0,y0,size): Leaf}

    def write_ctu(self, ctu_x: int, ctu_y: int):
        self._tree(ctu_x, ctu_y, self.ctu, self.ctu, True)

    def _tree(self, x0: int, y0: int, w: int, h: int, qt_allowed: bool):
        if x0 >= self.w or y0 >= self.h:
            return
        inside = (x0 + w <= self.w) and (y0 + h <= self.h)
        if not inside or w > 64 or h > 64:
            # implicit QT, no flag: picture-boundary nodes (spec 7.4.11)
            # and CTU-128 nodes above MaxCUSize 64 (CommonDef MAX_CU_SIZE)
            half = w >> 1
            for (dx, dy) in ((0, 0), (half, 0), (0, half), (half, half)):
                self._tree(x0 + dx, y0 + dy, half, half, qt_allowed)
            return
        can = allowed_splits(w, h, qt_allowed, self.mtt_enabled)
        if not any(can):
            code = SPLIT_NONE
        else:
            code = self.split_map[(x0, y0, w, h)]
            self.enc.encode_bin(
                0 if code == SPLIT_NONE else 1,
                self.ctxs("SPLIT_CU_FLAG", self._split_ctx(x0, y0, w, h)))
        if code == SPLIT_NONE:
            self._cu(self.leaf_map[(x0, y0, w, h)])
            return
        can_qt, bh, bv, th, tv = can
        is_qt = code == SPLIT_QT
        if can_qt and (bh or bv or th or tv):
            self.enc.encode_bin(
                1 if is_qt else 0,
                self.ctxs("SPLIT_QT_FLAG", 1 if w == self.ctu else 0))
        else:
            assert is_qt == can_qt or not is_qt, "split code illegal here"
        if is_qt:
            assert can_qt
            for (cx, cy, cw, ch) in child_blocks(x0, y0, w, h, SPLIT_QT):
                self._tree(cx, cy, cw, ch, True)
            return
        vert = code in (SPLIT_BT_V, SPLIT_TT_V)
        can_hor, can_ver = (bh or th), (bv or tv)
        if can_hor and can_ver:
            self.enc.encode_bin(
                1 if vert else 0,
                self.ctxs("MTT_SPLIT_VERT", 0 if w == h else 1))
        else:
            assert vert == can_ver
        is_bt = code in (SPLIT_BT_H, SPLIT_BT_V)
        can_b = bv if vert else bh
        can_t = tv if vert else th
        if can_b and can_t:
            self.enc.encode_bin(1 if is_bt else 0,
                                self.ctxs("MTT_SPLIT_BINARY", 0))
        else:
            assert is_bt == can_b
        for (cx, cy, cw, ch) in child_blocks(x0, y0, w, h, code):
            self._tree(cx, cy, cw, ch, False)

    def _cu(self, leaf: Leaf):
        enc, ctxs = self.enc, self.ctxs
        if leaf.w != leaf.h:
            # rect leaves are intra-only (MTT gated to intra slices)
            self._cu_intra(leaf)
            return
        x0, y0, size = leaf.x0, leaf.y0, leaf.size
        if self.inter_slice:
            is_inter = leaf.pred == 1
            cbf_any = bool(leaf.cbf_y or leaf.cbf_cb or leaf.cbf_cr)
            midx = None
            mmvd = None
            is_gpm = leaf.gpm is not None
            if leaf.decided:
                # mode_decide precomputed the merge/MMVD match against the
                # same MotionState evolution — serialize, don't re-derive
                midx, mmvd = leaf.merge_match, leaf.mmvd
            elif (is_inter and not leaf.affine and not is_gpm
                    and leaf.bcw == 2):
                cands = self._merge_list(x0, y0, size)
                midx = self._match_merge(leaf, cands)
                if midx is None and self.mmvd_enabled:
                    mmvd = self._match_mmvd(leaf, cands)
            skip = (is_inter and midx is not None and not cbf_any
                    and not leaf.ciip)
            enc.encode_bin(1 if skip else 0,
                           ctxs("CU_SKIP_FLAG", self._skip_ctx(x0, y0)))
            if skip:
                self._write_merge_idx(midx)
                leaf.skip, leaf.merge, leaf.merge_idx = True, True, midx
                self._mark_inter(leaf, skip=True)
                return
            enc.encode_bin(0 if is_inter else 1,
                           ctxs("PRED_MODE", self._pred_mode_ctx(x0, y0)))
            if is_inter:
                merge = midx is not None or mmvd is not None or is_gpm
                enc.encode_bin(1 if merge else 0, ctxs("MERGE_FLAG", 0))
                if merge:
                    if self._gpm_signaled(size):
                        # merge_gpm_flag (the regular_merge_flag inverse;
                        # reference: CABACWriter::merge_data geo branch)
                        enc.encode_bin(1 if is_gpm else 0,
                                       ctxs("GPM_FLAG", 0))
                    if is_gpm:
                        gm, i0, i1 = leaf.gpm
                        # merge_gpm_partition_idx: 64 modes = 6 EP bins
                        enc.encode_bins_ep(gm, 6)
                        self._write_gpm_idx(i0, self.max_merge)
                        self._write_gpm_idx(i1 - (1 if i1 > i0 else 0),
                                            self.max_merge - 1)
                        leaf.merge, leaf.merge_idx = True, i0
                    elif self.mmvd_enabled:
                        # mmvd_merge_flag (reference: CABACWriter::
                        # merge_data MMVD branch)
                        enc.encode_bin(1 if mmvd is not None else 0,
                                       ctxs("MMVD_FLAG", 0))
                    if mmvd is not None:
                        ci, di, gi = mmvd
                        enc.encode_bin(ci, ctxs("MMVD_CAND", 0))
                        enc.encode_bin(1 if di > 0 else 0,
                                       ctxs("MMVD_DIST", 0))
                        if di > 0:
                            for _ in range(di - 1):
                                enc.encode_bin_ep(1)
                            if di < len(self.MMVD_DISTS) - 1:
                                enc.encode_bin_ep(0)
                        enc.encode_bins_ep(gi, 2)
                        leaf.merge, leaf.merge_idx = True, ci
                    elif not is_gpm:
                        self._write_merge_idx(midx)
                        leaf.merge, leaf.merge_idx = True, midx
                        if self._ciip_signaled(size):
                            enc.encode_bin(1 if leaf.ciip else 0,
                                           ctxs("CIIP_FLAG", 0))
                else:
                    # inter_affine_flag + cu_affine_type_flag (reference:
                    # CABACWriter::affine_flag; spec gates on w,h >= 16
                    # for AMVP affine)
                    if self._affine_signaled(size):
                        enc.encode_bin(1 if leaf.affine else 0,
                                       ctxs("AFFINE_FLAG", 0))
                        if leaf.affine:
                            enc.encode_bin(1 if leaf.affine == 6 else 0,
                                           ctxs("AFFINE_TYPE", 0))
                    if self.is_b:
                        bi = leaf.inter_dir == 3
                        enc.encode_bin(
                            1 if bi else 0,
                            ctxs("INTER_DIR",
                                 min(4, size.bit_length() - 4)))
                        if not bi:
                            enc.encode_bin(1 if leaf.inter_dir == 2 else 0,
                                           ctxs("INTER_DIR", 5))
                    if leaf.affine:
                        if leaf.decided:
                            plans = leaf.amvp
                        else:
                            from vvc_torch.enc.mode_decide import _affine_plan
                            plans = _affine_plan(self.mstate, leaf, x0, y0,
                                                 size)
                        for (l, pi, mvds) in plans:
                            self._write_ref_idx(l, leaf.ref_idx[l])
                            # CPMV MVDs vs one shared translational
                            # predictor (simplified affine AMVP —
                            # reference: PU::fillAffineMvpCand)
                            for (dx, dy) in mvds:
                                self._write_mvd(dx, dy)
                            enc.encode_bin(pi, ctxs("MVP_FLAG", 0))
                    else:
                        # translational AMVP: every list's mvd derived up
                        # front so SMVD (one mvd for both lists) and AMVR
                        # (amvr_precision AFTER mvd_coding, spec 7.3.11.8)
                        # can be serialized together
                        if leaf.decided:
                            plan, smvd, imv = leaf.amvp, leaf.smvd, leaf.imv
                        else:
                            from vvc_torch.enc.mode_decide import (_amvp_plan,
                                                             smvd_refs)
                            plan = _amvp_plan(self.mstate, leaf, x0, y0,
                                              size)
                            sref = (smvd_refs(self.cur_poc, self.ref_pocs)
                                    if self.smvd_enabled else None)
                            smvd = bool(
                                sref is not None and len(plan) == 2
                                and sref == (leaf.ref_idx[0],
                                             leaf.ref_idx[1])
                                and plan[0][2] == -plan[1][2]
                                and plan[0][3] == -plan[1][3]
                                and (plan[0][2] or plan[0][3]))
                            comps = [c for (_, _, dx, dy) in plan
                                     for c in (dx, dy)]
                            imv = 0
                            if self.amvr_enabled and any(comps):
                                if all(c % 16 == 0 for c in comps):
                                    imv = 2
                                elif all(c % 4 == 0 for c in comps):
                                    imv = 1
                        if (self.smvd_enabled and leaf.inter_dir == 3
                                and self._smvd_refs() is not None):
                            # sym_mvd_flag (reference: CABACWriter::smvd_mode)
                            enc.encode_bin(1 if smvd else 0,
                                           ctxs("SMVD_FLAG", 0))
                        comps = [c for (_, _, dx, dy) in plan
                                 for c in (dx, dy)]
                        sh = (0, 2, 4)[imv]
                        for (l, pi, dx, dy) in plan:
                            if smvd and l == 1:
                                # L1 inherits ref (symmetric) and -mvd0;
                                # only its mvp_idx is coded
                                enc.encode_bin(pi, ctxs("MVP_FLAG", 0))
                                continue
                            if not smvd:
                                self._write_ref_idx(l, leaf.ref_idx[l])
                            self._write_mvd(dx >> sh, dy >> sh)
                            enc.encode_bin(pi, ctxs("MVP_FLAG", 0))
                        if self.amvr_enabled and any(comps):
                            # amvr_flag/amvr_precision_idx (reference:
                            # CABACWriter::cu_imv — derive-at-write: only
                            # signaled coarser when every component fits)
                            enc.encode_bin(1 if imv > 0 else 0,
                                           ctxs("IMV_FLAG", 0))
                            if imv > 0:
                                enc.encode_bin(1 if imv > 1 else 0,
                                               ctxs("IMV_FLAG", 1))
                        if self.bcw_enabled and leaf.inter_dir == 3:
                            # bcw_idx (reference: CABACWriter::cu_bcw_flag)
                            nz = leaf.bcw != 2
                            enc.encode_bin(1 if nz else 0,
                                           ctxs("BCW_IDX", 0))
                            if nz:
                                enc.encode_bins_ep(
                                    (0, 1, None, 2, 3)[leaf.bcw], 2)
                enc.encode_bin(1 if cbf_any else 0, ctxs("ROOT_CBF", 0))
                if cbf_any:
                    self._residuals(leaf)
                self._mark_inter(leaf, skip=False)
                return
        self._cu_intra(leaf)

    def _match_mmvd(self, leaf: Leaf, cands):
        """(base_cand, dist_idx, dir_idx) expressing the leaf's motion as
        merge-base + MMVD offset, else None (same derive-at-write pattern
        as _match_merge; reference: EncCu::xCheckRDCostMerge MMVD loop)."""
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
            if mag not in self.MMVD_DISTS:
                continue
            di = self.MMVD_DISTS.index(mag)
            gi = self.MMVD_DIRS.index((1 if dx > 0 else (-1 if dx < 0 else 0),
                                       1 if dy > 0 else (-1 if dy < 0 else 0)))
            # every used list must carry the SAME offset
            _, applied, _ = self._mmvd_apply(cands[ci], di, gi)
            ok = all(not ((d >> l) & 1)
                     or (applied[l][0] == leaf.mv[l][0]
                         and applied[l][1] == leaf.mv[l][1])
                     for l in (0, 1))
            if ok:
                return ci, di, gi
        return None

    def _match_merge(self, leaf: Leaf, cands):
        """Index of the merge candidate equal to the leaf's motion, else
        None (the encoder signals merge whenever its decided motion is
        derivable — the batched-RDO counterpart of the reference's explicit
        merge-mode RD check).  Shared derivation with the encoder's
        recon-time CIIP decision (vvc_torch.model.motion.match_merge)."""
        from vvc_torch.model.motion import match_merge
        return match_merge(leaf, cands)

    def _write_gpm_idx(self, idx: int, n: int):
        """merge_gpm_idx: first bin ctx-coded, EP unary tail over n values
        (reference: CABACWriter::merge_idx GPM branch)."""
        if n <= 1:
            return
        self.enc.encode_bin(1 if idx > 0 else 0, self.ctxs("GPM_IDX", 0))
        if idx > 0:
            for _ in range(idx - 1):
                self.enc.encode_bin_ep(1)
            if idx < n - 1:
                self.enc.encode_bin_ep(0)

    def _write_merge_idx(self, idx: int):
        if self.max_merge <= 1:
            return
        enc = self.enc
        enc.encode_bin(1 if idx > 0 else 0, self.ctxs("MERGE_IDX", 0))
        if idx > 0:
            for _ in range(idx - 1):
                enc.encode_bin_ep(1)
            if idx < self.max_merge - 1:
                enc.encode_bin_ep(0)

    def _write_ref_idx(self, lst: int, ridx: int):
        n = self.n_ref[lst]
        if n <= 1:
            return
        enc = self.enc
        enc.encode_bin(1 if ridx > 0 else 0, self.ctxs("REF_IDX", 0))
        if n > 2 and ridx > 0:
            enc.encode_bin(1 if ridx > 1 else 0, self.ctxs("REF_IDX", 1))
            for k in range(2, n - 1):
                if ridx <= k:
                    break
                enc.encode_bin_ep(1)
            if 2 <= ridx < n - 1:
                enc.encode_bin_ep(0)

    def _write_mvd(self, dx: int, dy: int):
        """mvd_coding (spec 7.3.11.8): gt0/gt1 ctx flags, EG1 remainder,
        sign — per component."""
        enc, ctxs = self.enc, self.ctxs
        for v in (dx, dy):
            a = abs(v)
            enc.encode_bin(1 if a > 0 else 0, ctxs("MVD", 0))
        for v in (dx, dy):
            if v != 0:
                enc.encode_bin(1 if abs(v) > 1 else 0, ctxs("MVD", 1))
        for v in (dx, dy):
            a = abs(v)
            if a > 0:
                if a > 1:
                    _eg_write(enc, a - 2, 1)
                enc.encode_bin_ep(1 if v < 0 else 0)

    def _cu_intra(self, leaf: Leaf):
        from vvc_torch.kernels.mip import mip_allowed, K_MIP_MODES
        enc, ctxs = self.enc, self.ctxs
        x0, y0, mode = leaf.x0, leaf.y0, leaf.luma_mode
        w, h = leaf.w, leaf.h
        is_mip = mode >= 67
        # intra_bdpcm_luma_flag (+ direction) — lossless TS tier; BDPCM
        # infers the prediction mode (18 H / 50 V), so the whole mode tree
        # is skipped (spec 7.3.11.5; reference: CABACWriter::bdpcm_mode)
        if self.lossless_enabled:
            enc.encode_bin(1 if leaf.bdpcm else 0, ctxs("BDPCM_FLAG", 0))
            if leaf.bdpcm:
                enc.encode_bin(leaf.bdpcm - 1, ctxs("BDPCM_DIR", 0))
                if not (self.cclm_enabled and w == h and leaf.chroma_mode):
                    enc.encode_bin(1, ctxs("INTRA_CHROMA_PRED_MODE", 0))
                self._residuals(leaf)
                d = node_depth(self.ctu, w, h)
                self.state.set_cu(x0, y0, w, mode, d, h=h)
                self.state.mark_coded(x0, y0, w, h=h)
                if self.inter_slice:
                    self.mstate.set_intra(x0, y0, w)
                return
        # intra_mip_flag + mode (TB), before the conventional mode tree
        # (square leaves only — the MIP weight ROM is square)
        if self.mip_enabled and w == h and mip_allowed(w):
            enc.encode_bin(1 if is_mip else 0, ctxs("MIP_FLAG", 0))
            if is_mip:
                _tb_write(enc, mode - 67, K_MIP_MODES)
        else:
            assert not is_mip, "MIP mode chosen but not signalable"
        if not is_mip:
            # intra_luma_ref_idx: truncated-unary over lines {0,1,2}
            # (reference: CABACWriter::extend_ref_line; first-CTU-row
            # gate = the spec's line-buffer constraint)
            if (y0 % self.ctu) > 0:
                mrl = leaf.mrl
                enc.encode_bin(1 if mrl > 0 else 0,
                               ctxs("INTRA_LUMA_REF_IDX", 0))
                if mrl > 0:
                    enc.encode_bin(1 if mrl > 1 else 0,
                                   ctxs("INTRA_LUMA_REF_IDX", 1))
            else:
                assert leaf.mrl == 0, "MRL needs an in-CTU above line"
            # intra_subpartitions_mode_flag (+ split direction when both
            # legal); spec 7.3.11.5 parses ISP only on ref line 0
            # (reference: CABACWriter::intra_luma_pred_modes ISP part)
            if self.isp_enabled and leaf.mrl == 0:
                from vvc_torch.kernels.isp import isp_allowed
                can_h, can_v = isp_allowed(w, h)
                if can_h or can_v:
                    enc.encode_bin(1 if leaf.isp else 0, ctxs("ISP_MODE", 0))
                    if leaf.isp and can_h and can_v:
                        enc.encode_bin(leaf.isp - 1, ctxs("ISP_MODE", 1))
            else:
                assert leaf.isp == 0, "ISP chosen but not signalable"
            left, above = self._neighbor_modes(x0, y0, w, h)
            mpm = mpm_list(left, above)
            if mode in mpm:
                idx = mpm.index(mode)
                enc.encode_bin(1, ctxs("INTRA_LUMA_MPM_FLAG", 0))
                enc.encode_bin(0 if idx == 0 else 1,
                               ctxs("INTRA_LUMA_NOT_PLANAR", 0))
                if idx > 0:
                    # truncated-unary of idx-1, cMax 4, bypass
                    for i in range(idx - 1):
                        enc.encode_bin_ep(1)
                    if idx - 1 < 4:
                        enc.encode_bin_ep(0)
            else:
                enc.encode_bin(0, ctxs("INTRA_LUMA_MPM_FLAG", 0))
                rem = sorted(set(range(67)) - set(mpm))
                _tb_write(enc, rem.index(mode), len(rem))
        # chroma mode: optional cclm_mode_flag, then DM (bin 1 = DM);
        # CCLM gated to square leaves (rect model derivation lands later)
        cclm_ok = self.cclm_enabled and w == h
        if cclm_ok:
            is_lm = leaf.chroma_mode != 0
            enc.encode_bin(1 if is_lm else 0, ctxs("CCLM_FLAG", 0))
            if is_lm:
                # cclm_mode_idx: LM, LM_L, LM_T (reference CABACWriter::
                # intra_chroma_lmc_mode TU shape)
                enc.encode_bin(1 if leaf.chroma_mode == 1 else 0,
                               ctxs("CCLM_MODE", 0))
                if leaf.chroma_mode != 1:
                    enc.encode_bin_ep(leaf.chroma_mode - 2)
        else:
            assert leaf.chroma_mode == 0 or cclm_ok
        if not (cclm_ok and leaf.chroma_mode):
            enc.encode_bin(1, ctxs("INTRA_CHROMA_PRED_MODE", 0))
        self._residuals(leaf)
        tr = _trace()
        if tr.enabled:
            tr.emit("SYNTAX", x=x0, y=y0, w=w, h=h, mode=mode,
                    cm=leaf.chroma_mode, mts=leaf.mts if leaf.cbf_y else 0,
                    lfnst=leaf.lfnst if leaf.cbf_y else 0,
                    cbf=[leaf.cbf_y, leaf.cbf_cb, leaf.cbf_cr])
        d = node_depth(self.ctu, w, h)
        # neighbours see a MIP CU as planar (spec MPM rule shape)
        self.state.set_cu(x0, y0, w, PLANAR_IDX if is_mip else mode, d, h=h)
        self.state.mark_coded(x0, y0, w, h=h)
        if self.inter_slice:
            self.mstate.set_intra(x0, y0, w)

    def _residuals(self, leaf: Leaf):
        enc, ctxs = self.enc, self.ctxs
        # CBFs (order: cb, cr, luma — reference CABACWriter order)
        cbf_cb, cbf_cr, cbf_y = leaf.cbf_cb, leaf.cbf_cr, leaf.cbf_y
        enc.encode_bin(cbf_cb, ctxs("CBF_CB", 0))
        enc.encode_bin(cbf_cr, ctxs("CBF_CR", cbf_cb))
        if self.lossless_enabled:
            # TS residual coding for every TB (lossless = transform skip
            # at 1-step quant; spec residual_ts_coding)
            from vvc_torch.cabac.residual_ts import write_residual_ts
            enc.encode_bin(cbf_y, ctxs("CBF_LUMA", 0))
            if cbf_cb:
                write_residual_ts(enc, ctxs, leaf.lev_cb, is_luma=False)
            if cbf_cr:
                write_residual_ts(enc, ctxs, leaf.lev_cr, is_luma=False)
            if cbf_y:
                write_residual_ts(enc, ctxs, leaf.lev_y, is_luma=True,
                                  bdpcm=leaf.bdpcm)
            return
        if leaf.isp:
            # per-sub-TU luma cbf (ctx 2 + prev-cbf, reference cbf_luma ISP
            # contexts) + per-sub residual; MTS/LFNST are implicit/off
            from vvc_torch.kernels.isp import isp_partitions
            if cbf_cb:
                write_residual(enc, ctxs, leaf.lev_cb, is_luma=False)
            if cbf_cr:
                write_residual(enc, ctxs, leaf.lev_cr, is_luma=False)
            prev = 0
            for part in isp_partitions(leaf.w, leaf.h, leaf.isp):
                sub_cbf = leaf.sub_cbf_y(part)
                enc.encode_bin(sub_cbf, ctxs("CBF_LUMA", 2 + prev))
                if sub_cbf:
                    xo, yo, sw, sh = part
                    write_residual(enc, ctxs,
                                   leaf.lev_y[yo:yo + sh, xo:xo + sw],
                                   is_luma=True)
                prev = sub_cbf
            return
        enc.encode_bin(cbf_y, ctxs("CBF_LUMA", 0))
        if self._mts_signaled(leaf.w, cbf_y, leaf.h) and leaf.pred == 0:
            # mts_idx: truncated unary, cMax 4, one ctx per bin (reference:
            # CABACWriter::mts_idx)
            for i in range(leaf.mts):
                enc.encode_bin(1, ctxs("MTS_IDX", i))
            if leaf.mts < 4:
                enc.encode_bin(0, ctxs("MTS_IDX", leaf.mts))
        if self._lfnst_signaled(leaf.w, cbf_y, leaf.mts, leaf.pred,
                                h=leaf.h):
            # lfnst_idx: truncated unary, cMax 2 (reference:
            # CABACWriter::residual_lfnst_mode)
            enc.encode_bin(1 if leaf.lfnst else 0, ctxs("LFNST_IDX", 0))
            if leaf.lfnst:
                enc.encode_bin(leaf.lfnst - 1, ctxs("LFNST_IDX", 1))
        if cbf_cb:
            write_residual(enc, ctxs, leaf.lev_cb, is_luma=False)
        if cbf_cr:
            write_residual(enc, ctxs, leaf.lev_cr, is_luma=False)
        if cbf_y:
            write_residual(enc, ctxs, leaf.lev_y, is_luma=True)


class TreeReader(TreeCoder):
    def __init__(self, dec, ctxs, state, width, height, ctu_size=64, min_cu=8,
                 mts_enabled=False, cclm_enabled=False, **kw):
        super().__init__(ctxs, state, width, height, ctu_size, min_cu,
                         mts_enabled, cclm_enabled, **kw)
        self.dec = dec
        self.leaves: list[Leaf] = []

    def read_ctu(self, ctu_x: int, ctu_y: int):
        self._tree(ctu_x, ctu_y, self.ctu, self.ctu, True)

    def _tree(self, x0: int, y0: int, w: int, h: int, qt_allowed: bool):
        if x0 >= self.w or y0 >= self.h:
            return
        inside = (x0 + w <= self.w) and (y0 + h <= self.h)
        if not inside or w > 64 or h > 64:
            # implicit QT, no flag: picture-boundary nodes (spec 7.4.11)
            # and CTU-128 nodes above MaxCUSize 64 (CommonDef MAX_CU_SIZE)
            half = w >> 1
            for (dx, dy) in ((0, 0), (half, 0), (0, half), (half, half)):
                self._tree(x0 + dx, y0 + dy, half, half, qt_allowed)
            return
        can = allowed_splits(w, h, qt_allowed, self.mtt_enabled)
        split = any(can) and bool(self.dec.decode_bin(
            self.ctxs("SPLIT_CU_FLAG", self._split_ctx(x0, y0, w, h))))
        if not split:
            self._cu(x0, y0, w, h)
            return
        can_qt, bh, bv, th, tv = can
        if can_qt and (bh or bv or th or tv):
            is_qt = bool(self.dec.decode_bin(
                self.ctxs("SPLIT_QT_FLAG", 1 if w == self.ctu else 0)))
        else:
            is_qt = can_qt
        if is_qt:
            for (cx, cy, cw, ch) in child_blocks(x0, y0, w, h, SPLIT_QT):
                self._tree(cx, cy, cw, ch, True)
            return
        can_hor, can_ver = (bh or th), (bv or tv)
        if can_hor and can_ver:
            vert = bool(self.dec.decode_bin(
                self.ctxs("MTT_SPLIT_VERT", 0 if w == h else 1)))
        else:
            vert = can_ver
        can_b = bv if vert else bh
        can_t = tv if vert else th
        if can_b and can_t:
            is_bt = bool(self.dec.decode_bin(
                self.ctxs("MTT_SPLIT_BINARY", 0)))
        else:
            is_bt = can_b
        code = ((SPLIT_BT_V if vert else SPLIT_BT_H) if is_bt
                else (SPLIT_TT_V if vert else SPLIT_TT_H))
        for (cx, cy, cw, ch) in child_blocks(x0, y0, w, h, code):
            self._tree(cx, cy, cw, ch, False)

    def _cu(self, x0: int, y0: int, size: int, h: int | None = None):
        dec, ctxs = self.dec, self.ctxs
        if h is not None and h != size:
            # rect leaves are intra-only (MTT is gated to intra slices)
            self._cu_intra(x0, y0, size, h)
            return
        if self.inter_slice:
            from vvc_torch.model.motion import amvp_candidates
            skip = dec.decode_bin(ctxs("CU_SKIP_FLAG",
                                       self._skip_ctx(x0, y0)))
            if skip:
                midx = self._read_merge_idx()
                cands = self._merge_list(x0, y0, size)
                leaf = self._leaf_from_cand(x0, y0, size, cands[midx], midx,
                                            skip=True)
                self._mark_inter(leaf, skip=True)
                self.leaves.append(leaf)
                return
            intra = dec.decode_bin(ctxs("PRED_MODE",
                                        self._pred_mode_ctx(x0, y0)))
            if not intra:
                merge = dec.decode_bin(ctxs("MERGE_FLAG", 0))
                if merge:
                    is_gpm = (self._gpm_signaled(size)
                              and dec.decode_bin(ctxs("GPM_FLAG", 0)))
                    if is_gpm:
                        from vvc_torch.kernels.gpm import gpm_uni_candidates
                        gm = dec.decode_bins_ep(6)
                        i0 = self._read_gpm_idx(self.max_merge)
                        j1 = self._read_gpm_idx(self.max_merge - 1)
                        i1 = j1 + (1 if j1 >= i0 else 0)
                        cands = self._merge_list(x0, y0, size)
                        uni = gpm_uni_candidates(cands)
                        # corrupt-stream guard: coded gpm indices must land
                        # on real uni candidates (matches the 'termination
                        # missing' style of stream validation)
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
                        leaf.gpm = (gm, i0, i1)
                        leaf.gpm_mv = (c0, c1)
                        if dec.decode_bin(ctxs("ROOT_CBF", 0)):
                            self._read_residuals(leaf)
                        self._mark_inter(leaf, skip=False)
                        self.leaves.append(leaf)
                        return
                    is_mmvd = (self.mmvd_enabled
                               and dec.decode_bin(ctxs("MMVD_FLAG", 0)))
                    if is_mmvd:
                        ci = dec.decode_bin(ctxs("MMVD_CAND", 0))
                        di = 0
                        if dec.decode_bin(ctxs("MMVD_DIST", 0)):
                            di = 1
                            while (di < len(self.MMVD_DISTS) - 1
                                   and dec.decode_bin_ep()):
                                di += 1
                        gi = dec.decode_bins_ep(2)
                        cands = self._merge_list(x0, y0, size)
                        applied = self._mmvd_apply(cands[ci], di, gi)
                        leaf = self._leaf_from_cand(x0, y0, size, applied,
                                                    ci, skip=False)
                    else:
                        midx = self._read_merge_idx()
                        cands = self._merge_list(x0, y0, size)
                        leaf = self._leaf_from_cand(x0, y0, size,
                                                    cands[midx], midx,
                                                    skip=False)
                        if self._ciip_signaled(size):
                            leaf.ciip = bool(
                                dec.decode_bin(ctxs("CIIP_FLAG", 0)))
                else:
                    affine = 0
                    if self._affine_signaled(size):
                        if dec.decode_bin(ctxs("AFFINE_FLAG", 0)):
                            affine = 6 if dec.decode_bin(
                                ctxs("AFFINE_TYPE", 0)) else 4
                    d = 1
                    if self.is_b:
                        if dec.decode_bin(ctxs("INTER_DIR",
                                               min(4, size.bit_length() - 4))):
                            d = 3
                        elif dec.decode_bin(ctxs("INTER_DIR", 5)):
                            d = 2
                    mv = [(0, 0), (0, 0)]
                    cpmv = [None, None]
                    ref = [0, 0]
                    bcw = 2
                    if affine:
                        for l in (0, 1):
                            if not (d >> l) & 1:
                                continue
                            ref[l] = self._read_ref_idx(l)
                            ncp = 2 if affine == 4 else 3
                            dxys = [self._read_mvd()
                                    for _ in range(ncp)]
                            pi = dec.decode_bin(ctxs("MVP_FLAG", 0))
                            mvp = amvp_candidates(self.mstate, x0, y0,
                                                  size, l, ref[l])
                            cpmv[l] = tuple(
                                (mvp[pi][0] + dx, mvp[pi][1] + dy)
                                for dx, dy in dxys)
                    else:
                        smvd = False
                        if (self.smvd_enabled and d == 3
                                and self._smvd_refs() is not None):
                            smvd = bool(dec.decode_bin(ctxs("SMVD_FLAG", 0)))
                        if smvd:
                            ref[0], ref[1] = self._smvd_refs()
                        raw = {}
                        for l in (0, 1):
                            if not (d >> l) & 1:
                                continue
                            if smvd:
                                dxy = self._read_mvd() if l == 0 else None
                            else:
                                ref[l] = self._read_ref_idx(l)
                                dxy = self._read_mvd()
                            pi = dec.decode_bin(ctxs("MVP_FLAG", 0))
                            raw[l] = (dxy, pi)
                        comps = [c for (dxy, _) in raw.values()
                                 if dxy is not None for c in dxy]
                        imv = 0
                        if self.amvr_enabled and any(comps):
                            if dec.decode_bin(ctxs("IMV_FLAG", 0)):
                                imv = 1 + dec.decode_bin(
                                    ctxs("IMV_FLAG", 1))
                        sh = (0, 2, 4)[imv]
                        mvd0 = None
                        for l, (dxy, pi) in raw.items():
                            if dxy is None:        # SMVD L1: -mvd0
                                sdx, sdy = -mvd0[0], -mvd0[1]
                            else:
                                sdx, sdy = dxy[0] << sh, dxy[1] << sh
                                if l == 0:
                                    mvd0 = (sdx, sdy)
                            mvp = amvp_candidates(self.mstate, x0, y0,
                                                  size, l, ref[l])
                            mv[l] = (mvp[pi][0] + sdx, mvp[pi][1] + sdy)
                        if self.bcw_enabled and d == 3:
                            if dec.decode_bin(ctxs("BCW_IDX", 0)):
                                bcw = (0, 1, 3, 4)[dec.decode_bins_ep(2)]
                    leaf = Leaf(x0, y0, size, size, pred=1, inter_dir=d,
                                mv=tuple(mv), ref_idx=tuple(ref),
                                affine=affine, cpmv=tuple(cpmv), bcw=bcw)
                if dec.decode_bin(ctxs("ROOT_CBF", 0)):
                    self._read_residuals(leaf)
                self._mark_inter(leaf, skip=False)
                self.leaves.append(leaf)
                return
        self._cu_intra(x0, y0, size)

    def _leaf_from_cand(self, x0, y0, size, cand, midx, skip):
        d, mv, ref = cand
        return Leaf(x0, y0, size, size, pred=1, skip=skip, merge=True,
                    merge_idx=midx, inter_dir=d,
                    mv=((int(mv[0][0]), int(mv[0][1])),
                        (int(mv[1][0]), int(mv[1][1]))),
                    ref_idx=(int(ref[0]) if d & 1 else 0,
                             int(ref[1]) if d & 2 else 0))

    def _read_gpm_idx(self, n: int) -> int:
        if n <= 1:
            return 0
        dec = self.dec
        if not dec.decode_bin(self.ctxs("GPM_IDX", 0)):
            return 0
        idx = 1
        while idx < n - 1 and dec.decode_bin_ep():
            idx += 1
        return idx

    def _read_merge_idx(self) -> int:
        if self.max_merge <= 1:
            return 0
        dec = self.dec
        if not dec.decode_bin(self.ctxs("MERGE_IDX", 0)):
            return 0
        idx = 1
        while idx < self.max_merge - 1 and dec.decode_bin_ep():
            idx += 1
        return idx

    def _read_ref_idx(self, lst: int) -> int:
        n = self.n_ref[lst]
        if n <= 1:
            return 0
        dec = self.dec
        if not dec.decode_bin(self.ctxs("REF_IDX", 0)):
            return 0
        if n == 2 or not dec.decode_bin(self.ctxs("REF_IDX", 1)):
            return 1
        ridx = 2
        while ridx < n - 1 and dec.decode_bin_ep():
            ridx += 1
        return ridx

    def _read_mvd(self):
        dec, ctxs = self.dec, self.ctxs
        gt0 = [dec.decode_bin(ctxs("MVD", 0)) for _ in range(2)]
        gt1 = [dec.decode_bin(ctxs("MVD", 1)) if g else 0 for g in gt0]
        out = []
        for g0, g1 in zip(gt0, gt1):
            if not g0:
                out.append(0)
                continue
            a = (_eg_read(dec, 1) + 2) if g1 else 1
            out.append(-a if dec.decode_bin_ep() else a)
        return out

    def _cu_intra(self, x0: int, y0: int, size: int, h: int | None = None):
        from vvc_torch.kernels.mip import mip_allowed, K_MIP_MODES
        dec, ctxs = self.dec, self.ctxs
        w = size
        h = w if h is None else h
        if self.lossless_enabled:
            if dec.decode_bin(ctxs("BDPCM_FLAG", 0)):
                bdpcm = 1 + dec.decode_bin(ctxs("BDPCM_DIR", 0))
                mode = 18 if bdpcm == 1 else 50   # inferred H / V
                dm = dec.decode_bin(ctxs("INTRA_CHROMA_PRED_MODE", 0))
                assert dm == 1
                leaf = Leaf(x0, y0, w, h, mode, bdpcm=bdpcm)
                self._read_residuals(leaf)
                d = node_depth(self.ctu, w, h)
                self.state.set_cu(x0, y0, w, mode, d, h=h)
                self.state.mark_coded(x0, y0, w, h=h)
                if self.inter_slice:
                    self.mstate.set_intra(x0, y0, w)
                self.leaves.append(leaf)
                return
        is_mip = False
        if self.mip_enabled and w == h and mip_allowed(w):
            is_mip = bool(dec.decode_bin(ctxs("MIP_FLAG", 0)))
        isp = 0
        mrl = 0
        if is_mip:
            mode = 67 + _tb_read(dec, K_MIP_MODES)
        else:
            if (y0 % self.ctu) > 0:
                if dec.decode_bin(ctxs("INTRA_LUMA_REF_IDX", 0)):
                    mrl = 1 + dec.decode_bin(ctxs("INTRA_LUMA_REF_IDX", 1))
            # spec 7.3.11.5: intra_subpartitions syntax only on ref line 0
            if self.isp_enabled and mrl == 0:
                from vvc_torch.kernels.isp import isp_allowed
                can_h, can_v = isp_allowed(w, h)
                if (can_h or can_v) and dec.decode_bin(ctxs("ISP_MODE", 0)):
                    if can_h and can_v:
                        isp = 1 + dec.decode_bin(ctxs("ISP_MODE", 1))
                    else:
                        isp = 1 if can_h else 2
            left, above = self._neighbor_modes(x0, y0, w, h)
            mpm = mpm_list(left, above)
            if dec.decode_bin(ctxs("INTRA_LUMA_MPM_FLAG", 0)):
                if dec.decode_bin(ctxs("INTRA_LUMA_NOT_PLANAR", 0)):
                    idx = 1
                    while idx - 1 < 4 and dec.decode_bin_ep():
                        idx += 1
                    mode = mpm[idx]
                else:
                    mode = mpm[0]
            else:
                rem = sorted(set(range(67)) - set(mpm))
                mode = rem[_tb_read(dec, len(rem))]
        chroma_mode = 0
        if self.cclm_enabled and w == h:
            if dec.decode_bin(ctxs("CCLM_FLAG", 0)):
                if dec.decode_bin(ctxs("CCLM_MODE", 0)):
                    chroma_mode = 1
                else:
                    chroma_mode = 2 + dec.decode_bin_ep()
        if not chroma_mode:
            dm = dec.decode_bin(ctxs("INTRA_CHROMA_PRED_MODE", 0))
            assert dm == 1, "non-DM chroma not supported yet"
        leaf = Leaf(x0, y0, w, h, mode, isp=isp, chroma_mode=chroma_mode,
                    mrl=0 if is_mip else mrl)
        self._read_residuals(leaf)
        tr = _trace()
        if tr.enabled:
            tr.emit("SYNTAX", x=x0, y=y0, w=w, h=h, mode=mode,
                    cm=leaf.chroma_mode, mts=leaf.mts if leaf.cbf_y else 0,
                    lfnst=leaf.lfnst if leaf.cbf_y else 0,
                    cbf=[leaf.cbf_y, leaf.cbf_cb, leaf.cbf_cr])
        d = node_depth(self.ctu, w, h)
        self.state.set_cu(x0, y0, w, PLANAR_IDX if is_mip else mode, d, h=h)
        self.state.mark_coded(x0, y0, w, h=h)
        if self.inter_slice:
            self.mstate.set_intra(x0, y0, w)
        self.leaves.append(leaf)

    def _read_residuals(self, leaf: Leaf):
        dec, ctxs = self.dec, self.ctxs
        w, h = leaf.w, leaf.h
        cbf_cb = dec.decode_bin(ctxs("CBF_CB", 0))
        cbf_cr = dec.decode_bin(ctxs("CBF_CR", cbf_cb))
        if self.lossless_enabled:
            from vvc_torch.cabac.residual_ts import read_residual_ts
            cbf_y = dec.decode_bin(ctxs("CBF_LUMA", 0))
            cw, ch = w >> 1, h >> 1
            if cbf_cb:
                leaf.lev_cb = read_residual_ts(dec, ctxs, (cw, ch),
                                               is_luma=False)
            if cbf_cr:
                leaf.lev_cr = read_residual_ts(dec, ctxs, (cw, ch),
                                               is_luma=False)
            if cbf_y:
                leaf.lev_y = read_residual_ts(dec, ctxs, (w, h),
                                              is_luma=True,
                                              bdpcm=leaf.bdpcm)
            return
        if leaf.isp:
            from vvc_torch.kernels.isp import isp_partitions
            cw, ch = w >> 1, h >> 1
            if cbf_cb:
                leaf.lev_cb = read_residual(dec, ctxs, (cw, ch),
                                            is_luma=False)
            if cbf_cr:
                leaf.lev_cr = read_residual(dec, ctxs, (cw, ch),
                                            is_luma=False)
            lev_y = np.zeros((h, w), dtype=np.int32)
            any_y = False
            prev = 0
            for (xo, yo, sw, sh) in isp_partitions(w, h, leaf.isp):
                sub_cbf = dec.decode_bin(ctxs("CBF_LUMA", 2 + prev))
                if sub_cbf:
                    lev_y[yo:yo + sh, xo:xo + sw] = read_residual(
                        dec, ctxs, (sw, sh), is_luma=True)
                    any_y = True
                prev = sub_cbf
            leaf.lev_y = lev_y if any_y else None
            return
        cbf_y = dec.decode_bin(ctxs("CBF_LUMA", 0))
        if self._mts_signaled(w, cbf_y, h) and leaf.pred == 0:
            while leaf.mts < 4 and dec.decode_bin(ctxs("MTS_IDX", leaf.mts)):
                leaf.mts += 1
        if self._lfnst_signaled(w, cbf_y, leaf.mts, leaf.pred, h=h):
            if dec.decode_bin(ctxs("LFNST_IDX", 0)):
                leaf.lfnst = 1 + dec.decode_bin(ctxs("LFNST_IDX", 1))
        cw, ch = w >> 1, h >> 1
        if cbf_cb:
            leaf.lev_cb = read_residual(dec, ctxs, (cw, ch), is_luma=False)
        if cbf_cr:
            leaf.lev_cr = read_residual(dec, ctxs, (cw, ch), is_luma=False)
        if cbf_y:
            leaf.lev_y = read_residual(dec, ctxs, (w, h), is_luma=True)

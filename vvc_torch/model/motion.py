"""Motion field state + merge/AMVP candidate derivation.

TPU-native analog of the reference's motion model
(`VTM/source/Lib/CommonLib/MotionInfo.h` → MotionInfo/MotionBuf
4×4-granularity field; UnitTools.cpp → PU::getInterMergeCandidates,
PU::fillMvpCand; OpenVVC libovvc/drv_mvp.c).  SoA per-4×4 planes like
CodingState (SURVEY.md §7.0 tenet 1).

Covers spatial A1,B1,B0,A0,B2 + TMVP (POC-scaled, C0/C1) + HMVP FIFO +
pairwise-average + zero padding.  Remaining simplifications vs the spec
([verify] tags): AMVP neighbours contribute cross-list MVs without
POC-distance scaling, and MV storage is quarter-pel (not 1/16-pel).
Encoder and decoder call the SAME functions on identically-updated
state, which is what end-to-end bit-exactness rests on.
"""
from __future__ import annotations

import numpy as np

MAX_MERGE_CAND = 6


class MotionState:
    """Per-4×4 motion planes, updated in syntax (z-)order by writer+reader."""

    def __init__(self, width: int, height: int):
        self.w4 = (width + 3) >> 2
        self.h4 = (height + 3) >> 2
        self.mv = np.zeros((self.h4, self.w4, 2, 2), dtype=np.int32)
        self.ref = np.full((self.h4, self.w4, 2), -1, dtype=np.int8)
        self.inter = np.zeros((self.h4, self.w4), dtype=bool)
        self.coded = np.zeros((self.h4, self.w4), dtype=bool)
        self.skip = np.zeros((self.h4, self.w4), dtype=bool)
        # HMVP FIFO (reference: HPMVInfo table, spec 8.5.2.16): most
        # recent last; translational inter CUs only
        self.hmvp = []

    def set_inter(self, x0, y0, size, inter_dir, mv, ref_idx,
                  skip: bool = False):
        s4 = size >> 2
        ys, xs = y0 >> 2, x0 >> 2
        sl = (slice(ys, ys + s4), slice(xs, xs + s4))
        self.inter[sl] = True
        self.coded[sl] = True
        self.skip[sl] = skip
        for l in range(2):
            use = (inter_dir >> l) & 1
            self.mv[sl + (l,)] = np.asarray(mv[l] if use else (0, 0))
            self.ref[sl + (l,)] = ref_idx[l] if use else -1
        # HMVP update: dedup then FIFO-append, capacity 5 (spec: remove the
        # identical entry, shift, append newest)
        ent = (inter_dir,
               np.array([[int(mv[0][0]), int(mv[0][1])]
                         if inter_dir & 1 else [0, 0],
                         [int(mv[1][0]), int(mv[1][1])]
                         if inter_dir & 2 else [0, 0]], dtype=np.int32),
               np.array([ref_idx[0] if inter_dir & 1 else -1,
                         ref_idx[1] if inter_dir & 2 else -1],
                        dtype=np.int8))
        k = _cand_key(ent)
        self.hmvp = [c for c in self.hmvp if _cand_key(c) != k]
        self.hmvp.append(ent)
        if len(self.hmvp) > 5:
            self.hmvp.pop(0)

    def set_inter_affine(self, x0, y0, w, h, inter_dir, cpmv, ref_idx,
                         affine_type: int):
        """Store an affine CU's SUBBLOCK motion field (reference: the spec
        stores the derived 4×4 subblock MVs in the motion buffer, so
        translational neighbours/TMVP inherit subblock motion)."""
        from vvc_torch.kernels.affine import affine_mv_grid
        ys, xs = y0 >> 2, x0 >> 2
        sl = (slice(ys, ys + (h >> 2)), slice(xs, xs + (w >> 2)))
        self.inter[sl] = True
        self.coded[sl] = True
        self.skip[sl] = False
        for l in range(2):
            use = (inter_dir >> l) & 1
            if use:
                self.mv[sl + (l,)] = affine_mv_grid(w, h, cpmv[l],
                                                    affine_type)
                self.ref[sl + (l,)] = ref_idx[l]
            else:
                self.mv[sl + (l,)] = 0
                self.ref[sl + (l,)] = -1

    def set_intra(self, x0, y0, size):
        s4 = size >> 2
        ys, xs = y0 >> 2, x0 >> 2
        sl = (slice(ys, ys + s4), slice(xs, xs + s4))
        self.inter[sl] = False
        self.coded[sl] = True
        self.ref[sl] = -1

    def at(self, x: int, y: int):
        """Motion info of the 4×4 unit containing luma (x, y); None if
        unavailable / not inter."""
        if x < 0 or y < 0 or (x >> 2) >= self.w4 or (y >> 2) >= self.h4:
            return None
        ys, xs = y >> 2, x >> 2
        if not self.coded[ys, xs] or not self.inter[ys, xs]:
            return None
        return (self.mv[ys, xs].copy(), self.ref[ys, xs].copy())


class ColMotion:
    """Persisted motion field of a decoded picture, for TMVP (reference:
    MotionBuf stored per Picture; Slice colFromL0).  Built identically by
    encoder and decoder from the final leaf list."""

    def __init__(self, mv, ref, inter, poc: int, ref_pocs):
        self.mv = mv            # [h4, w4, 2, 2] qpel
        self.ref = ref          # [h4, w4, 2] ref idx or -1
        self.inter = inter      # [h4, w4] bool
        self.poc = poc
        self.ref_pocs = ref_pocs  # (l0 tuple, l1 tuple) of POCs


def motion_field_from_leaves(leaves, width: int, height: int, poc: int,
                             ref_pocs) -> ColMotion:
    ms = MotionState(width, height)
    for l in leaves:
        if l.pred == 1:
            if l.affine:
                ms.set_inter_affine(l.x0, l.y0, l.w, l.h, l.inter_dir,
                                    l.cpmv, l.ref_idx, l.affine)
            else:
                ms.set_inter(l.x0, l.y0, l.size, l.inter_dir, l.mv,
                             l.ref_idx)
    return ColMotion(ms.mv, ms.ref, ms.inter, poc, ref_pocs)


def scale_mv(mv, tb: int, td: int):
    """Deterministic integer POC-distance scaling (reference:
    PU::getDistScaleFactor shape; exact spec fixed-point [verify])."""
    if td == 0 or tb == td:
        return (int(mv[0]), int(mv[1]))

    def sc(v):
        v = int(v) * tb * 2
        return (v + (td if v >= 0 else -td)) // (2 * td)
    return (max(-(1 << 17), min((1 << 17) - 1, sc(mv[0]))),
            max(-(1 << 17), min((1 << 17) - 1, sc(mv[1]))))


def temporal_candidate(col: ColMotion, x0: int, y0: int, size: int,
                       cur_poc: int, ref_pocs, is_b: bool):
    """TMVP: collocated C0 (bottom-right) with C1 (center) fallback,
    MV scaled to each list's ref 0 (reference: PU::getColocatedMVP)."""
    if col is None:
        return None
    h4, w4 = col.inter.shape
    for px, py in ((x0 + size, y0 + size),
                   (x0 + size // 2, y0 + size // 2)):
        cx, cy = px >> 2, py >> 2
        if not (0 <= cx < w4 and 0 <= cy < h4) or not col.inter[cy, cx]:
            continue
        # source list: first available on the col picture
        src = 0 if col.ref[cy, cx, 0] >= 0 else 1
        cmv = col.mv[cy, cx, src]
        cref = int(col.ref[cy, cx, src])
        td = col.poc - col.ref_pocs[src][cref]
        mv = [(0, 0), (0, 0)]
        ref = [0, 0]
        d = 0
        if ref_pocs[0]:
            tb = cur_poc - ref_pocs[0][0]
            mv[0] = scale_mv(cmv, tb, td)
            d |= 1
        if is_b and ref_pocs[1]:
            tb = cur_poc - ref_pocs[1][0]
            mv[1] = scale_mv(cmv, tb, td)
            d |= 2
        if d == 0:
            return None
        return (d, np.array(mv, dtype=np.int32),
                np.array(ref, dtype=np.int8))
    return None


def _cand_key(c):
    d, mv, ref = c
    return (d, tuple(mv[0]) if d & 1 else None, int(ref[0]) if d & 1 else -1,
            tuple(mv[1]) if d & 2 else None, int(ref[1]) if d & 2 else -1)


def merge_candidates(ms: MotionState, x0: int, y0: int, size: int,
                     is_b: bool, n_ref_l0: int, n_ref_l1: int,
                     max_cand: int = MAX_MERGE_CAND, tmvp=None):
    """Merge list: spatial A1,B1,B0,A0,(B2) + TMVP + zero-MV padding.

    tmvp: precomputed temporal candidate (temporal_candidate()) or None.
    Returns list of (inter_dir, mv [2,2] int array, ref_idx [2]) of length
    max_cand.  Reference: PU::getInterMergeCandidates — spatial
    A1,B1,B0,A0,(B2), TMVP, HMVP (newest first), pairwise-average, zero
    padding."""
    s = size
    pos = [(x0 - 1, y0 + s - 1),   # A1
           (x0 + s - 1, y0 - 1),   # B1
           (x0 + s, y0 - 1),       # B0
           (x0 - 1, y0 + s),       # A0
           (x0 - 1, y0 - 1)]       # B2
    cands = []
    seen = set()
    for i, (px, py) in enumerate(pos):
        if i == 4 and len(cands) >= 4:
            break  # B2 only when fewer than 4 spatial candidates (spec)
        info = ms.at(px, py)
        if info is None:
            continue
        mv, ref = info
        d = (1 if ref[0] >= 0 else 0) | (2 if ref[1] >= 0 else 0)
        if not is_b:
            d &= 1
        if d == 0:
            continue
        c = (d, mv, ref)
        k = _cand_key(c)
        if k in seen:
            continue
        seen.add(k)
        cands.append(c)
        if len(cands) >= max_cand:
            break
    if tmvp is not None and len(cands) < max_cand:
        d, mv, ref = tmvp
        if not is_b:
            d &= 1
        if d:
            k = _cand_key((d, mv, ref))
            if k not in seen:
                seen.add(k)
                cands.append((d, mv, ref))
    # HMVP candidates, newest first (reference: PU::addMergeHMVPCand)
    for c in reversed(ms.hmvp):
        if len(cands) >= max_cand - 1:
            break                       # spec keeps one slot headroom
        d, mv, ref = c
        if not is_b:
            d &= 1
        if d == 0:
            continue
        cc = (d, mv, ref)
        k = _cand_key(cc)
        if k not in seen:
            seen.add(k)
            cands.append(cc)
    # pairwise-average of the first two candidates (spec 8.5.2.4)
    if len(cands) >= 2 and len(cands) < max_cand:
        d0, mv0, r0 = cands[0]
        d1, mv1, r1 = cands[1]
        mv = np.zeros((2, 2), dtype=np.int32)
        ref = np.full(2, -1, dtype=np.int8)
        d = 0
        for l in (0, 1):
            a, b = (d0 >> l) & 1, (d1 >> l) & 1
            if a and b:
                mv[l] = (mv0[l].astype(np.int64)
                         + mv1[l] + 1) >> 1
                ref[l] = r0[l]
                d |= 1 << l
            elif a:
                mv[l] = mv0[l]
                ref[l] = r0[l]
                d |= 1 << l
            elif b:
                mv[l] = mv1[l]
                ref[l] = r1[l]
                d |= 1 << l
        if not is_b:
            d &= 1
        if d:
            c = (d, mv, ref)
            k = _cand_key(c)
            if k not in seen:
                seen.add(k)
                cands.append(c)
    # zero-MV padding cycling ref indices (spec: zero merge candidates)
    zref = 0
    while len(cands) < max_cand:
        if is_b and n_ref_l1 > 0:
            d = 3
            ref = np.array([min(zref, n_ref_l0 - 1),
                            min(zref, n_ref_l1 - 1)], dtype=np.int8)
        else:
            d = 1
            ref = np.array([min(zref, n_ref_l0 - 1), -1], dtype=np.int8)
        cands.append((d, np.zeros((2, 2), dtype=np.int32), ref))
        zref += 1
    return cands


def amvp_candidates(ms: MotionState, x0: int, y0: int, size: int,
                    lst: int, ref_idx: int):
    """2-entry AMVP list for (list, ref_idx).

    Reference: PU::fillMvpCand.  Simplification ([verify]): a neighbour
    contributes its MV for the requested list if it has one, else its MV
    from the other list — no POC-distance scaling (self-consistent since
    both sides derive identically)."""
    s = size
    left_pos = [(x0 - 1, y0 + s), (x0 - 1, y0 + s - 1)]          # A0, A1
    above_pos = [(x0 + s, y0 - 1), (x0 + s - 1, y0 - 1),
                 (x0 - 1, y0 - 1)]                                # B0, B1, B2

    def first_mv(positions):
        for px, py in positions:
            info = ms.at(px, py)
            if info is None:
                continue
            mv, ref = info
            if ref[lst] >= 0:
                return tuple(int(v) for v in mv[lst])
            if ref[1 - lst] >= 0:
                return tuple(int(v) for v in mv[1 - lst])
        return None

    cands = []
    a = first_mv(left_pos)
    if a is not None:
        cands.append(a)
    b = first_mv(above_pos)
    if b is not None and b not in cands:
        cands.append(b)
    while len(cands) < 2:
        cands.append((0, 0))
    return cands


def match_merge(leaf, cands):
    """Index of the merge candidate equal to the leaf's motion, else None
    (shared by the syntax writer and the encoder's recon-time CIIP
    decision — both must see the SAME derivation)."""
    for i, (d, mv, ref) in enumerate(cands):
        if d != leaf.inter_dir:
            continue
        ok = True
        for l in (0, 1):
            if (d >> l) & 1:
                if (int(mv[l][0]) != leaf.mv[l][0]
                        or int(mv[l][1]) != leaf.mv[l][1]
                        or int(ref[l]) != leaf.ref_idx[l]):
                    ok = False
                    break
        if ok:
            return i
    return None

"""Intra prediction: planar, DC, 65 angular modes (+PDPC).

TPU-native analog of the reference's IntraPrediction
(`VTM/source/Lib/CommonLib/IntraPrediction.cpp` →
predIntraAng / xPredIntraPlanar / xPredIntraDc / initIntraPatternChType;
OpenVVC: libovvc/rcn_intra*.c, drv_intra.c).

Design (SURVEY.md §2.2): "All 65 angular modes = gather + linear interp
along rows → batched gather kernel."  The reference computes one block at a
time from a freshly assembled reference array; here the reference L-shape
is flattened into one line C of length 4S+3:

    C = [ left[2S], ..., left[1], corner, top[1], ..., top[2S], pad, pad ]
          index 0              2S-1   2S   2S+1        4S        (+2 pad)

and every angular mode m becomes a *static* pair of gather-index matrices
IDX/IDX2 plus fraction weights FACT into C (negative-angle projections via
invAngle folded in at table-build time).  The batched path evaluates all
modes × all blocks of one size from the same tables: plain PyTorch
(`predict_all_modes_batch_plain`) or the CUDA kernel
`vvc_torch/csrc/intra_pred.cu`, chosen by `predict_all_modes_batch`; and
`predict_modes_batch` predicts one given mode per block (the chroma DM of
the RD search) from the same tables and kernel source.

PDPC (position-dependent prediction combination, spec 8.4.5.2.14;
reference IntraPrediction.cpp → the applyPDPC blocks of predIntraAng):
planar/DC use the two-sided weighted blend; VER/HOR (v-space mode 50) use
the difference form against the corner; modes past vertical (v-space
51..82, which covers signaled 2..10 and 58..66 plus wide-angle) blend
with the opposite-side reference found along invAngle.  All of it is
static per (shape, mode), so it rides the same gather-table design as the
4-tap interpolation: pdpc_ang_tables() yields (W, I, diff) matrices and
every implementation (numpy oracle, batched torch, CUDA) applies the
identical integer update.  [verify] exact spec clamping when the
invAngle row exceeds the 2H reference extent (we zero the weight).
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np

import torch

from vvc_torch import ops
from vvc_torch.common.types import PLANAR_IDX, DC_IDX, VER_IDX, DIA_IDX

# spec 8.4.5.2.12 intraPredAngle table, indexed by |mode - 50| (or |18-mode|);
# entries beyond 16 are the wide-angle extension (rect blocks, spec Table 27
# lineage — [verify] exact wide entries once the reference mount populates;
# self-consistent encoder/decoder meanwhile)
_ABS_ANG = [0, 1, 2, 3, 4, 6, 8, 10, 12, 14, 16, 18, 20, 23, 26, 29, 32,
            35, 39, 45, 51, 57, 64, 73, 86, 102, 128, 171, 256, 341, 512,
            682, 1024]


def pred_angle(mode: int) -> int:
    """Signed intraPredAngle for the (extended) vertical family
    (mode in [34, 82]; wide-angle modes beyond 66 map past the diagonal)."""
    idx = mode - VER_IDX  # -16..32
    return int(np.sign(idx)) * _ABS_ANG[abs(idx)]


def wide_angle_remap(mode: int, w: int, h: int) -> int:
    """Wide-angle mode substitution for W≠H blocks (reference:
    IntraPrediction getModifiedWideAngle / spec 8.4.5.2.7).  Signaled mode
    2..66 → effective mode in [-14, 80]; square blocks unchanged."""
    if w == h or mode < 2 or mode > 66:
        return mode
    ratio = min(2, abs(int(np.log2(w)) - int(np.log2(h))))
    if w > h and mode < (8 + 2 * ratio if ratio > 1 else 8):
        return mode + 65
    if h > w and mode > (60 - 2 * ratio if ratio > 1 else 60):
        return mode - 67
    return mode


def inv_angle(angle: int) -> int:
    assert angle != 0
    a = abs(angle)
    return (512 * 32 + a // 2) // a


# ---------------------------------------------------------------------------
# PDPC for angular modes (spec 8.4.5.2.14 analog) — static per (shape, mode)
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def pdpc_ang_tables(wv: int, hv: int, vmode: int):
    """PDPC tables for an (extended-)vertical-family mode in v-space.

    v-space: block wv×hv predicted from line C with corner at index 2·hv
    (left samples C[2hv-1-k]).  Horizontal-family modes reuse these tables
    on the reversed line with (wv, hv) swapped, exactly like the 4-tap
    interpolation tables.

    Returns (W [hv,wv] i32, I [hv,wv] i32 index into C, diff: bool) or
    None when PDPC is off for this mode/shape.
      diff form (VER, vmode 50): out = pred + ((W·(C[I] − C[2hv])) >> 6)
      avg  form (vmode  > 50):   out = pred + ((W·(C[I] − pred) + 32) >> 6)
    (the avg form equals (W·ref + (64−W)·pred + 32) >> 6 exactly).
    """
    if vmode < 50 or vmode > 82:
        return None
    log2w, log2h = int(np.log2(wv)), int(np.log2(hv))
    if vmode == 50:
        scale = (log2w + log2h - 2) >> 2
        xs = np.arange(wv)
        wl = (32 >> np.minimum(31, (2 * xs) >> scale)).astype(np.int32)
        W = np.broadcast_to(wl[None, :], (hv, wv)).copy()
        ys = np.arange(hv)
        I = np.broadcast_to((2 * hv - 1 - ys)[:, None], (hv, wv)).copy()
        return W, I.astype(np.int32), True
    angle = pred_angle(vmode)
    ia = inv_angle(angle)
    scale = min(2, log2h - (int(np.log2(3 * ia - 2)) - 8))
    if scale < 0:
        return None
    xs = np.arange(wv)
    dy = (256 + (xs + 1) * ia) >> 9
    wl = np.where(xs < min(3 << scale, wv),
                  32 >> np.minimum(31, (2 * xs) >> scale), 0)
    ys = np.arange(hv)
    row = ys[:, None] + dy[None, :]                      # [hv, wv]
    ok = row < 2 * hv
    W = np.where(ok, wl[None, :], 0).astype(np.int32)
    I = np.where(ok, 2 * hv - 1 - np.minimum(row, 2 * hv - 1),
                 2 * hv).astype(np.int32)
    return W, I, False


def apply_pdpc_ang_np(pred: np.ndarray, c: np.ndarray, wv: int, hv: int,
                      vmode: int) -> np.ndarray:
    """Apply angular PDPC to a v-space prediction (numpy oracle form)."""
    t = pdpc_ang_tables(wv, hv, vmode)
    if t is None:
        return pred
    W, I, diff = t
    ref = c[I].astype(np.int64)
    if diff:
        return pred + ((W * (ref - int(c[2 * hv]))) >> 6)
    return pred + ((W * (ref - pred) + 32) >> 6)


# ---------------------------------------------------------------------------
# Reference line construction (oracle; reference: initIntraPatternChType)
# ---------------------------------------------------------------------------


def build_ref_line(plane: np.ndarray, coded: np.ndarray, x0: int, y0: int,
                   size: int, bit_depth: int = 8, log2_unit: int = 2) -> np.ndarray:
    """Build the flattened reference line C (length 4S+3) for an S×S block
    at (x0, y0) of `plane`, honoring availability.

    `coded` is a per-(1<<log2_unit) boolean map of already-reconstructed
    units (kept identically by encoder and decoder, so availability —
    including above-right/below-left in z-order — is exact and symmetric).
    """
    s = size
    h, w = plane.shape
    n = 4 * s + 3
    c = np.zeros(n, dtype=np.int32)
    avail = np.zeros(n, dtype=bool)

    # left samples: C[2s-1-k] = plane[y0+k, x0-1], k = 0..2s-1
    ky = y0 + np.arange(2 * s)
    if x0 > 0:
        kyc = np.minimum(ky, h - 1)
        ok = (ky < h) & coded[kyc >> log2_unit, (x0 - 1) >> log2_unit]
        c[2 * s - 1::-1] = np.where(ok, plane[kyc, x0 - 1], 0)
        avail[2 * s - 1::-1] = ok
    # corner
    if x0 > 0 and y0 > 0 and coded[(y0 - 1) >> log2_unit, (x0 - 1) >> log2_unit]:
        c[2 * s] = plane[y0 - 1, x0 - 1]
        avail[2 * s] = True
    # top samples: C[2s+1+k] = plane[y0-1, x0+k], k = 0..2s-1
    kx = x0 + np.arange(2 * s)
    if y0 > 0:
        kxc = np.minimum(kx, w - 1)
        ok = (kx < w) & coded[(y0 - 1) >> log2_unit, kxc >> log2_unit]
        c[2 * s + 1:4 * s + 1] = np.where(ok, plane[y0 - 1, kxc], 0)
        avail[2 * s + 1:4 * s + 1] = ok

    # substitution (spec 8.4.5.2.8): if none available → mid-grey; else
    # propagate from the first available sample scanning C upward
    # (vectorized forward fill over the last-available index).
    if not avail.any():
        c[:] = 1 << (bit_depth - 1)
    else:
        ix = np.where(avail[:4 * s + 1], np.arange(4 * s + 1), -1)
        np.maximum.accumulate(ix, out=ix)
        first = int(np.argmax(avail))
        ix[ix < 0] = first
        c[:4 * s + 1] = c[:4 * s + 1][ix]
    c[4 * s + 1] = c[4 * s]  # pad
    c[4 * s + 2] = c[4 * s]
    return c


def build_ref_line_mrl(plane: np.ndarray, coded: np.ndarray, x0: int,
                       y0: int, size: int, bit_depth: int, k: int,
                       log2_unit: int = 2) -> np.ndarray:
    """Reference line at offset k (MRL lines 1/2): same layout as
    build_ref_line but reading column x0-1-k and row y0-1-k.

    Reference: IntraPrediction.cpp multiRefIdx extended-line fill.
    Deviation [verify]: the spec projects angular modes *through* the
    offset line (longer projection distance); here line k is substituted
    as the adjacent line, so MRL acts as alternative-line selection.
    Both codec halves share this function, so streams stay bit-exact."""
    s = size
    h, w = plane.shape
    n = 4 * s + 3
    c = np.zeros(n, dtype=np.int32)
    avail = np.zeros(n, dtype=bool)
    xl, yt = x0 - 1 - k, y0 - 1 - k
    ky = y0 + np.arange(2 * s)
    if xl >= 0:
        kyc = np.minimum(ky, h - 1)
        ok = (ky < h) & coded[kyc >> log2_unit, xl >> log2_unit]
        c[2 * s - 1::-1] = np.where(ok, plane[kyc, xl], 0)
        avail[2 * s - 1::-1] = ok
    if xl >= 0 and yt >= 0 and coded[yt >> log2_unit, xl >> log2_unit]:
        c[2 * s] = plane[yt, xl]
        avail[2 * s] = True
    kx = x0 + np.arange(2 * s)
    if yt >= 0:
        kxc = np.minimum(kx, w - 1)
        ok = (kx < w) & coded[yt >> log2_unit, kxc >> log2_unit]
        c[2 * s + 1:4 * s + 1] = np.where(ok, plane[yt, kxc], 0)
        avail[2 * s + 1:4 * s + 1] = ok
    if not avail.any():
        c[:] = 1 << (bit_depth - 1)
    else:
        ix = np.where(avail[:4 * s + 1], np.arange(4 * s + 1), -1)
        np.maximum.accumulate(ix, out=ix)
        first = int(np.argmax(avail))
        ix[ix < 0] = first
        c[:4 * s + 1] = c[:4 * s + 1][ix]
    c[4 * s + 1] = c[4 * s]
    c[4 * s + 2] = c[4 * s]
    return c


# ---------------------------------------------------------------------------
# Static per-mode gather tables
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def angular_tables(size: int, mode: int):
    """(IDX, IDX2, FACT) int32 [S, S] matrices into C for a vertical-family
    mode (34..66).  pred[y, x] = ((32-F)*C[IDX] + F*C[IDX2] + 16) >> 5.
    (Legacy 2-tap form, kept for host heuristics; the prediction paths use
    angular_tables4.)"""
    assert DIA_IDX <= mode <= 66
    s = size
    angle = pred_angle(mode)
    idx = np.empty((s, s), dtype=np.int32)
    idx2 = np.empty((s, s), dtype=np.int32)
    fact = np.empty((s, s), dtype=np.int32)
    ia = inv_angle(angle) if angle < 0 else 0

    def c_pos(k: int) -> int:  # E-space -> C-space
        if k >= 0:
            return min(2 * s + k, 4 * s + 2)
        i = -k
        return 2 * s - ((i * ia + 256) >> 9)

    for y in range(s):
        off = ((y + 1) * angle) >> 5
        f = ((y + 1) * angle) & 31
        for x in range(s):
            idx[y, x] = c_pos(x + off + 1)
            idx2[y, x] = c_pos(x + off + 2)
            fact[y, x] = f
    return idx, idx2, fact


@lru_cache(maxsize=None)
def angular_tables4(size: int, mode: int):
    """(IDX [4,S,S], CO [4,S,S]) gather tables for 4-tap fractional
    interpolation of a vertical-family mode (34..66); reference:
    IntraPrediction::xPredIntraAng's fC/fG interpolation
    (filters: vvc_torch/rom/intra_filters.py, analytically derived).

    pred[y, x] = (sum_k CO[k]*C[IDX[k]] + 32) >> 6."""
    assert DIA_IDX <= mode <= 66
    from vvc_torch.rom.intra_filters import (fc_filters, fg_filters,
                                       use_smooth_filter)
    s = size
    angle = pred_angle(mode)
    ia = inv_angle(angle) if angle < 0 else 0
    filt = (fg_filters() if use_smooth_filter(mode, int(np.log2(s)))
            else fc_filters())
    idx = np.empty((4, s, s), dtype=np.int32)
    co = np.empty((4, s, s), dtype=np.int32)

    def c_pos(k: int) -> int:  # E-space -> C-space (edge-clamped)
        if k >= 0:
            return min(2 * s + k, 4 * s + 2)
        i = -k
        return max(0, 2 * s - ((i * ia + 256) >> 9))

    for y in range(s):
        off = ((y + 1) * angle) >> 5
        f = ((y + 1) * angle) & 31
        for x in range(s):
            e = x + off + 1
            for k in range(4):
                idx[k, y, x] = c_pos(e + k - 1)
                co[k, y, x] = filt[f, k]
    return idx, co


@lru_cache(maxsize=None)
def angular_tables4_rect(w: int, h: int, vmode: int):
    """(IDX [4,H,W], CO [4,H,W]) gather tables for a W×H block and an
    extended vertical-family mode (34..82, wide-angle included).

    Reference-line layout generalizes the square one:
        C = [ left[2H] reversed, corner, top[2W], pad, pad ]   (2H+2W+3)
    For square blocks this is identical to angular_tables4's layout."""
    assert DIA_IDX <= vmode <= 82
    from vvc_torch.rom.intra_filters import (fc_filters, fg_filters,
                                       use_smooth_filter)
    angle = pred_angle(vmode)
    ia = inv_angle(angle) if angle < 0 else 0
    log2s = (int(np.log2(w)) + int(np.log2(h))) >> 1
    smooth_mode = vmode if vmode <= 66 else 66  # wide modes: smooth filter
    filt = (fg_filters() if use_smooth_filter(smooth_mode, log2s)
            else fc_filters())
    idx = np.empty((4, h, w), dtype=np.int32)
    co = np.empty((4, h, w), dtype=np.int32)
    base = 2 * h           # corner position
    last = 2 * h + 2 * w + 2

    def c_pos(k: int) -> int:  # E-space → C-space (edge-clamped)
        if k >= 0:
            return min(base + k, last)
        i = -k
        return max(0, base - ((i * ia + 256) >> 9))

    for y in range(h):
        off = ((y + 1) * angle) >> 5
        f = ((y + 1) * angle) & 31
        for x in range(w):
            e = x + off + 1
            for k in range(4):
                idx[k, y, x] = c_pos(e + k - 1)
                co[k, y, x] = filt[f, k]
    return idx, co


def build_ref_line_rect(plane: np.ndarray, coded: np.ndarray, x0: int,
                        y0: int, w: int, h: int, bit_depth: int = 8,
                        log2_unit: int = 2) -> np.ndarray:
    """Rect generalization of build_ref_line: C of length 2H+2W+3 for a
    W×H block (left 2H, corner, top 2W, 2 pads)."""
    ph, pw = plane.shape
    n = 2 * h + 2 * w + 3
    c = np.zeros(n, dtype=np.int32)
    avail = np.zeros(n, dtype=bool)
    ky = y0 + np.arange(2 * h)
    if x0 > 0:
        kyc = np.minimum(ky, ph - 1)
        ok = (ky < ph) & coded[kyc >> log2_unit, (x0 - 1) >> log2_unit]
        c[2 * h - 1::-1] = np.where(ok, plane[kyc, x0 - 1], 0)
        avail[2 * h - 1::-1] = ok
    if x0 > 0 and y0 > 0 and coded[(y0 - 1) >> log2_unit,
                                   (x0 - 1) >> log2_unit]:
        c[2 * h] = plane[y0 - 1, x0 - 1]
        avail[2 * h] = True
    kx = x0 + np.arange(2 * w)
    if y0 > 0:
        kxc = np.minimum(kx, pw - 1)
        ok = (kx < pw) & coded[(y0 - 1) >> log2_unit, kxc >> log2_unit]
        c[2 * h + 1:2 * h + 2 * w + 1] = np.where(ok, plane[y0 - 1, kxc], 0)
        avail[2 * h + 1:2 * h + 2 * w + 1] = ok
    lim = 2 * h + 2 * w + 1
    if not avail.any():
        c[:] = 1 << (bit_depth - 1)
    else:
        ix = np.where(avail[:lim], np.arange(lim), -1)
        np.maximum.accumulate(ix, out=ix)
        first = int(np.argmax(avail))
        ix[ix < 0] = first
        c[:lim] = c[:lim][ix]
    c[lim] = c[lim - 1]
    c[lim + 1] = c[lim - 1]
    return c


def predict_intra_rect(c: np.ndarray, mode: int, w: int, h: int,
                       bit_depth: int = 8) -> np.ndarray:
    """Predict one W×H block from its rect reference line (numpy oracle).
    Applies the wide-angle remap; planar/DC per spec rect rules; PDPC on
    planar/DC.  Square input = predict_intra semantics."""
    log2w, log2h = int(np.log2(w)), int(np.log2(h))
    left = c[2 * h - 1::-1][:2 * h]
    top = c[2 * h + 1:2 * h + 2 * w + 1]
    if mode == PLANAR_IDX:
        xs = np.arange(w)
        ys = np.arange(h)
        pred_v = ((h - 1 - ys)[:, None] * top[None, :w]
                  + (ys + 1)[:, None] * left[h][None, None]) << log2w
        pred_h = ((w - 1 - xs)[None, :] * left[:h][:, None]
                  + (xs + 1)[None, :] * top[w][None, None]) << log2h
        pred = (pred_v + pred_h + w * h) >> (log2w + log2h + 1)
    elif mode == DC_IDX:
        # spec rect DC: average over the longer side only
        if w == h:
            dc = (int(top[:w].sum()) + int(left[:h].sum()) + w) >> (log2w + 1)
        elif w > h:
            dc = (int(top[:w].sum()) + (w >> 1)) >> log2w
        else:
            dc = (int(left[:h].sum()) + (h >> 1)) >> log2h
        pred = np.full((h, w), dc, dtype=np.int32)
    else:
        m = wide_angle_remap(mode, w, h)
        if m >= DIA_IDX:
            idx, co = angular_tables4_rect(w, h, m)
            pred = ((co * c[idx].astype(np.int64)).sum(axis=0) + 32) >> 6
            pred = apply_pdpc_ang_np(pred, c, w, h, m)
        else:
            idx, co = angular_tables4_rect(h, w, 68 - m)
            lim = 2 * h + 2 * w + 1
            ct = c[:lim][::-1]
            ct = np.concatenate([ct, ct[-1:], ct[-1:]])
            pred = ((co * ct[idx].astype(np.int64)).sum(axis=0) + 32) >> 6
            pred = apply_pdpc_ang_np(pred, ct, h, w, 68 - m).T
        pred = pred.astype(np.int32)
    if mode in (PLANAR_IDX, DC_IDX) and min(w, h) >= 4:
        scale = ((log2w + log2h - 2) >> 2)
        xs = np.arange(w)
        ys = np.arange(h)
        wl = 32 >> np.minimum(31, (2 * xs) >> scale)
        wt = 32 >> np.minimum(31, (2 * ys) >> scale)
        pred = (wl[None, :] * left[:h][:, None].astype(np.int64)
                + wt[:, None] * top[None, :w]
                + (64 - wl[None, :] - wt[:, None]) * pred + 32) >> 6
    return np.clip(pred, 0, (1 << bit_depth) - 1).astype(np.int32)


# ---------------------------------------------------------------------------
# Oracle prediction (numpy, one block) — used by sequential recon paths
# ---------------------------------------------------------------------------


def _pdpc_planar_dc(pred: np.ndarray, c: np.ndarray, size: int) -> np.ndarray:
    s = size
    left = c[2 * s - 1::-1][:s]     # left[y], y = 0..s-1
    top = c[2 * s + 1: 2 * s + 1 + s]  # top[x]
    scale = ((2 * int(np.log2(s)) - 2) >> 2)
    xs = np.arange(s)
    wl = 32 >> np.minimum(31, (2 * xs) >> scale)   # [x]
    wt = 32 >> np.minimum(31, (2 * xs) >> scale)   # [y]
    out = (wl[None, :] * left[:, None] + wt[:, None] * top[None, :]
           + (64 - wl[None, :] - wt[:, None]) * pred + 32) >> 6
    return out


def predict_intra(c: np.ndarray, mode: int, size: int, bit_depth: int = 8,
                  pdpc: bool = True) -> np.ndarray:
    """Predict one S×S block from its reference line C.  Returns int32 [S, S].

    mode >= 67 dispatches to MIP (matrix intra prediction, no PDPC)."""
    if mode >= 67:
        from vvc_torch.kernels.mip import mip_predict_np
        return mip_predict_np(c, mode - 67, size, bit_depth)
    s = size
    log2s = int(np.log2(s))
    left = c[2 * s - 1::-1][:2 * s]  # left[k] = sample at (x0-1, y0+k)
    top = c[2 * s + 1:4 * s + 1]     # top[k] = sample at (x0+k, y0-1)

    if mode == PLANAR_IDX:
        xs = np.arange(s)
        ys = np.arange(s)
        pred_v = ((s - 1 - ys)[:, None] * top[None, :s]
                  + (ys + 1)[:, None] * left[s][None, None]) << log2s
        pred_h = ((s - 1 - xs)[None, :] * left[:s][:, None]
                  + (xs + 1)[None, :] * top[s][None, None]) << log2s
        pred = (pred_v + pred_h + s * s) >> (2 * log2s + 1)
    elif mode == DC_IDX:
        dc = (int(top[:s].sum()) + int(left[:s].sum()) + s) >> (log2s + 1)
        pred = np.full((s, s), dc, dtype=np.int32)
    else:
        if mode >= DIA_IDX:
            idx, co = angular_tables4(s, mode)
            pred = ((co * c[idx]).sum(axis=0) + 32) >> 6
            pred = apply_pdpc_ang_np(pred, c, s, s, mode)
        else:
            # horizontal family = transpose of vertical mode 68-m on the
            # reversed reference line (left/top swap roles)
            idx, co = angular_tables4(s, 68 - mode)
            ct = c[:4 * s + 1][::-1]
            ct = np.concatenate([ct, ct[-1:], ct[-1:]])
            pred = ((co * ct[idx]).sum(axis=0) + 32) >> 6
            pred = apply_pdpc_ang_np(pred, ct, s, s, 68 - mode).T
        pred = pred.astype(np.int32)

    if pdpc and mode in (PLANAR_IDX, DC_IDX) and s >= 4:
        pred = _pdpc_planar_dc(pred, c, s)
    return np.clip(pred, 0, (1 << bit_depth) - 1).astype(np.int32)


# ---------------------------------------------------------------------------
# Batched JAX prediction — all modes × all blocks of one size, for RDO
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _stacked_tables(size: int):
    """Stack per-mode 4-tap tables for the vertical family (modes 34..66):
    IDX [33,4,S,S] and CO [33,4,S,S] int32 arrays."""
    mats = [angular_tables4(size, m) for m in range(DIA_IDX, 67)]
    idx = np.stack([m[0] for m in mats])
    co = np.stack([m[1] for m in mats])
    return idx, co


@lru_cache(maxsize=None)
def _stacked_pdpc(wv: int, hv: int, vmodes: tuple):
    """Stack pdpc_ang_tables over a v-space mode tuple →
    (W [M,hv,wv], I [M,hv,wv], diff [M] bool); W rows are zero for modes
    without PDPC, so one fused update covers the whole stack."""
    m = len(vmodes)
    W = np.zeros((m, hv, wv), np.int32)
    I = np.full((m, hv, wv), 2 * hv, np.int32)
    diff = np.zeros(m, bool)
    for j, vm in enumerate(vmodes):
        t = pdpc_ang_tables(wv, hv, vm)
        if t is not None:
            W[j], I[j], diff[j] = t
    return W, I, diff


def _apply_pdpc_batch1(pred, cb, wv: int, hv: int, vmode: int, xp=np):
    """Single-mode batched angular PDPC: pred [N,hv,wv], cb [N,L]."""
    t = pdpc_ang_tables(wv, hv, vmode)
    if t is None:
        return pred
    W, I, diff = t
    ref = cb[:, I]
    if diff:
        corner = cb[:, 2 * hv][:, None, None]
        return pred + ((W[None] * (ref - corner)) >> 6)
    return pred + ((W[None] * (ref - pred) + 32) >> 6)


def _apply_pdpc_stack(pv, cb, wv: int, hv: int, vmodes, xp=np):
    """Apply the stacked angular PDPC to [N,M,hv,wv] v-space predictions
    gathered from [N,L] reference lines cb (numpy)."""
    W, I, diff = _stacked_pdpc(wv, hv, tuple(vmodes))
    if not W.any():
        return pv
    ref = cb[:, I]                                       # [N, M, hv, wv]
    corner = cb[:, 2 * hv][:, None, None, None]
    d = xp.where(diff[None, :, None, None],
                 (W[None] * (ref - corner)) >> 6,
                 (W[None] * (ref - pv) + 32) >> 6)
    return pv + d


def predict_all_modes_batch_np(c_batch: np.ndarray, size: int,
                               bit_depth: int = 8) -> np.ndarray:
    """Numpy twin of predict_all_modes_batch (identical integer semantics,
    no device/compile involvement) — used by host-side decision heuristics."""
    s = size
    log2s = int(np.log2(s))
    n = c_batch.shape[0]
    idx, co = _stacked_tables(size)
    left = c_batch[:, 2 * s - 1::-1]
    top = c_batch[:, 2 * s + 1:4 * s + 1]
    xs = np.arange(s)
    ys = np.arange(s)
    below_left = left[:, s][:, None, None]
    above_right = top[:, s][:, None, None]
    pred_v = ((s - 1 - ys)[None, :, None] * top[:, None, :s]
              + (ys + 1)[None, :, None] * below_left) << log2s
    pred_h = ((s - 1 - xs)[None, None, :] * left[:, :s, None]
              + (xs + 1)[None, None, :] * above_right) << log2s
    planar = (pred_v + pred_h + s * s) >> (2 * log2s + 1)
    dc = (np.sum(top[:, :s], axis=1) + np.sum(left[:, :s], axis=1) + s) >> (log2s + 1)
    dc_pred = np.broadcast_to(dc[:, None, None], (n, s, s)).copy()
    scale = (2 * log2s - 2) >> 2
    wl = (32 >> np.minimum(31, (2 * xs) >> scale))[None, None, :]
    wt = (32 >> np.minimum(31, (2 * ys) >> scale))[None, :, None]
    lcol = left[:, :s, None]
    trow = top[:, None, :s]

    def pdpc(p):
        return (wl * lcol + wt * trow + (64 - wl - wt) * p + 32) >> 6

    planar = pdpc(planar)
    dc_pred = pdpc(dc_pred)
    vmodes = tuple(range(DIA_IDX, 67))
    pv = ((co[None] * c_batch[:, idx]).sum(axis=2) + 32) >> 6
    pv = _apply_pdpc_stack(pv, c_batch, s, s, vmodes, xp=np)
    ct = c_batch[:, 4 * s::-1]
    ct = np.concatenate([ct, ct[:, -1:], ct[:, -1:]], axis=1)
    ph = ((co[None] * ct[:, idx]).sum(axis=2) + 32) >> 6
    ph = _apply_pdpc_stack(ph, ct, s, s, vmodes, xp=np).transpose(0, 1, 3, 2)
    hm = ph[:, np.arange(32, 0, -1)]
    out = np.concatenate([planar[:, None], dc_pred[:, None], hm, pv], axis=1)
    return np.clip(out, 0, (1 << bit_depth) - 1).astype(np.int32)


def predict_modes_np(c_batch: np.ndarray, modes: np.ndarray, size: int,
                     bit_depth: int = 8) -> np.ndarray:
    """Per-block single-mode prediction [N,S,S] (numpy, no device) — the
    mode-selected slice of predict_all_modes_batch_np without materializing
    all 67 clipped planes."""
    s = size
    n = c_batch.shape[0]
    out = np.empty((n, s, s), dtype=np.int64)
    # group by mode for table reuse
    order = np.argsort(modes, kind="stable")
    k = 0
    while k < n:
        m = modes[order[k]]
        j = k
        while j < n and modes[order[j]] == m:
            j += 1
        sel = order[k:j]
        cb = c_batch[sel]
        if m == PLANAR_IDX or m == DC_IDX:
            full = predict_all_modes_batch_np(cb, s, bit_depth)
            out[sel] = full[:, m]
            k = j
            continue
        if m >= DIA_IDX:
            idx, co = angular_tables4(s, int(m))
            p = ((co[None] * cb[:, idx]).sum(axis=1) + 32) >> 6
            out[sel] = _apply_pdpc_batch1(p, cb, s, s, int(m))
        else:
            idx, co = angular_tables4(s, 68 - int(m))
            ct = cb[:, 4 * s::-1]
            ct = np.concatenate([ct, ct[:, -1:], ct[:, -1:]], axis=1)
            p = ((co[None] * ct[:, idx]).sum(axis=1) + 32) >> 6
            out[sel] = _apply_pdpc_batch1(p, ct, s, s, 68 - int(m)
                                          ).transpose(0, 2, 1)
        k = j
    return np.clip(out, 0, (1 << bit_depth) - 1).astype(np.int32)


def build_ref_lines_orig_np(plane: np.ndarray, xs: np.ndarray, ys: np.ndarray,
                            size: int, bit_depth: int) -> np.ndarray:
    """Numpy ref lines from original samples (clamp availability) — host
    twin of vvc_torch.enc.rdo.build_ref_lines_device."""
    h, w = plane.shape
    s = size
    mid = 1 << (bit_depth - 1)
    k = np.arange(2 * s)
    lx = np.clip(xs - 1, 0, w - 1)
    lyy = np.clip(ys[:, None] + k[None, :], 0, h - 1)
    left = plane[lyy, lx[:, None]]
    ty = np.clip(ys - 1, 0, h - 1)
    txx = np.clip(xs[:, None] + k[None, :], 0, w - 1)
    top = plane[ty[:, None], txx]
    corner = plane[ty, lx]
    top = np.where((ys > 0)[:, None], top,
                   np.where((xs > 0)[:, None], left[:, :1], mid))
    corner = np.where(ys > 0, corner, np.where(xs > 0, left[:, 0], mid))
    left = np.where((xs > 0)[:, None], left,
                    np.where((ys > 0)[:, None], top[:, :1], mid))
    return np.concatenate(
        [left[:, ::-1], corner[:, None], top, top[:, -1:], top[:, -1:]],
        axis=1).astype(np.int32)


# ---------------------------------------------------------------------------
# The decoder's reference lines: the N leaves of one wave, read from the
# plane reconstructed so far with z-order availability
# ---------------------------------------------------------------------------


def build_ref_lines_wave_plain(plane: torch.Tensor, order_map: torch.Tensor,
                               xs: torch.Tensor, ys: torch.Tensor,
                               zis: torch.Tensor, size: int,
                               bit_depth: int = 8) -> torch.Tensor:
    """Plain twin of the `wave_ref_lines` kernel: build_ref_line for N
    S×S leaves at once → [N, 4S+3] int32.  A sample is available iff it
    lies in the plane and its 4×4 unit's order-map entry is below the
    leaf's zi."""
    s = size
    h, w = plane.shape
    dev = plane.device
    xs, ys, zis = xs.long(), ys.long(), zis.long()
    k = torch.arange(2 * s, device=dev)
    lx = (xs - 1).clamp(min=0)
    ty = (ys - 1).clamp(min=0)
    ly = ys[:, None] + k                                        # [N, 2S]
    lyc = ly.clamp(max=h - 1)
    lok = ((xs > 0)[:, None] & (ly < h)
           & (order_map[lyc >> 2, (lx >> 2)[:, None]] < zis[:, None]))
    cok = (xs > 0) & (ys > 0) & (order_map[ty >> 2, lx >> 2] < zis)
    tx = xs[:, None] + k
    txc = tx.clamp(max=w - 1)
    tok = ((ys > 0)[:, None] & (tx < w)
           & (order_map[(ty >> 2)[:, None], txc >> 2] < zis[:, None]))
    c = torch.cat([plane[lyc, lx[:, None]].flip(1), plane[ty, lx][:, None],
                   plane[ty[:, None], txc]], dim=1)             # [N, 4S+1]
    av = torch.cat([lok.flip(1), cok[:, None], tok], dim=1)
    pos = torch.arange(4 * s + 1, device=dev).expand_as(c)
    ix = torch.where(av, pos, -1).cummax(dim=1).values
    first = av.to(torch.int32).argmax(dim=1)
    ix = torch.where(ix < 0, first[:, None], ix)
    c = torch.where(av.any(dim=1)[:, None], c.gather(1, ix),
                    1 << (bit_depth - 1))
    return torch.cat([c, c[:, -1:], c[:, -1:]], dim=1).to(torch.int32)


def _ref_lines_wave_cuda(plane, order_map, xs, ys, zis, size: int,
                         bit_depth: int) -> torch.Tensor:
    ops.check_cuda_i32("wave_ref_lines", plane, order_map, xs, ys, zis)
    h, w = plane.shape
    n = xs.shape[0]
    if order_map.shape != ((h + 3) >> 2, (w + 3) >> 2):
        raise ValueError(f"wave_ref_lines: order map "
                         f"{tuple(order_map.shape)} does not cover {h}x{w}")
    if ys.shape != (n,) or zis.shape != (n,) or not 4 <= size <= 64:
        raise ValueError("wave_ref_lines: bad positions or size")
    out = torch.empty((n, 4 * size + 3), dtype=torch.int32,
                      device=plane.device)
    if n == 0:
        return out
    fn = ops.lib("wave_ref_lines").wave_ref_lines_launch
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    err = fn(plane.data_ptr(), h, w, order_map.data_ptr(), order_map.shape[1],
             xs.data_ptr(), ys.data_ptr(), zis.data_ptr(), n, size,
             bit_depth, out.data_ptr(), ops.stream_ptr(plane))
    ops.launched("wave_ref_lines", err)
    return out


def build_ref_lines_wave(plane: torch.Tensor, order_map: torch.Tensor,
                         xs: torch.Tensor, ys: torch.Tensor,
                         zis: torch.Tensor, size: int,
                         bit_depth: int = 8) -> torch.Tensor:
    """[H,W] int32 plane, [⌈H/4⌉,⌈W/4⌉] int32 order map and N leaves
    (x0, y0, zi) → [N, 4S+3] int32 reference lines, as build_ref_line
    builds them with availability `order_map < zi`.  Replaces the per-leaf
    host loop of vvc/dec/wavefront.py:78-82.  CUDA tensor →
    csrc/ref_lines.cu `wave_ref_lines`; CPU tensor or `ops.plain()` → the
    twin."""
    if ops.use_kernel(plane):
        return _ref_lines_wave_cuda(plane, order_map, xs, ys, zis, size,
                                    bit_depth)
    return build_ref_lines_wave_plain(plane, order_map, xs, ys, zis, size,
                                      bit_depth)


# ---------------------------------------------------------------------------
# Batched torch prediction — all modes × all blocks of one size, for RDO
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _device_tables(size: int, device: str):
    """Per-size tables as int32 tensors on `device`, uploaded once:
    idx/co [33,4,S,S] (4-tap, vertical family), PDPC W/I [33,S,S] and
    diff [33], and the planar/DC PDPC weights wl [S] (wt is the same)."""
    idx, co = _stacked_tables(size)
    W, I, diff = _stacked_pdpc(size, size, tuple(range(DIA_IDX, 67)))
    log2s = int(np.log2(size))
    scale = (2 * log2s - 2) >> 2
    wl = 32 >> np.minimum(31, (2 * np.arange(size)) >> scale)
    return tuple(torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)
                                  ).to(device)
                 for a in (idx, co, W, I, diff, wl))


def _planar_dc_plain(c: torch.Tensor, s: int, wl: torch.Tensor):
    """Planar and DC predictions of [N, 4S+3] int32 lines, each after its
    PDPC blend → two [N,S,S] int32 tensors (unclipped)."""
    log2s = int(np.log2(s))
    n = c.shape[0]
    left = c[:, :2 * s].flip(1)                       # left[k], k = 0..2S-1
    top = c[:, 2 * s + 1:4 * s + 1]
    ar = torch.arange(s, dtype=torch.int32, device=c.device)
    below_left = left[:, s][:, None, None]
    above_right = top[:, s][:, None, None]
    pred_v = ((s - 1 - ar)[None, :, None] * top[:, None, :s]
              + (ar + 1)[None, :, None] * below_left) << log2s
    pred_h = ((s - 1 - ar)[None, None, :] * left[:, :s, None]
              + (ar + 1)[None, None, :] * above_right) << log2s
    planar = (pred_v + pred_h + s * s) >> (2 * log2s + 1)
    dc = (top[:, :s].sum(1) + left[:, :s].sum(1) + s) >> (log2s + 1)
    dc_pred = dc[:, None, None].expand(n, s, s)
    wlx = wl[None, None, :]
    wty = wl[None, :, None]
    lcol = left[:, :s, None]
    trow = top[:, None, :s]

    def pdpc(p):
        return (wlx * lcol + wty * trow + (64 - wlx - wty) * p + 32) >> 6

    return pdpc(planar), pdpc(dc_pred)


def _reversed_line(c: torch.Tensor, s: int) -> torch.Tensor:
    """ct: the line reversed about its corner, padded like vvc's."""
    head = c[:, :4 * s + 1].flip(1)
    return torch.cat([head, head[:, -1:], head[:, -1:]], dim=1)


def predict_all_modes_batch_plain(c_batch: torch.Tensor, size: int,
                                  bit_depth: int = 8) -> torch.Tensor:
    """Plain PyTorch twin of predict_all_modes_batch_np: [N, 4S+3] int32
    reference lines → [N, 67, S, S] int32 (integer semantics identical)."""
    s = size
    dev = c_batch.device
    idx, co, W, I, diff, wl = _device_tables(s, str(dev))
    idx, I = idx.long(), I.long()
    c = c_batch.to(torch.int32)

    def angular(line):
        p = ((co[None] * line[:, idx]).sum(2) + 32) >> 6   # [N,33,S,S]
        ref = line[:, I]
        corner = line[:, 2 * s][:, None, None, None]
        d = torch.where(diff.bool()[None, :, None, None],
                        (W[None] * (ref - corner)) >> 6,
                        (W[None] * (ref - p) + 32) >> 6)
        return p + d

    planar, dc_pred = _planar_dc_plain(c, s, wl)
    pv = angular(c)
    ph = angular(_reversed_line(c, s)).transpose(2, 3)
    hm = ph[:, torch.arange(32, 0, -1, device=dev)]
    out = torch.cat([planar[:, None], dc_pred[:, None], hm, pv], dim=1)
    return out.clamp(0, (1 << bit_depth) - 1).to(torch.int32)


def _predict_all_cuda(c_batch: torch.Tensor, size: int,
                      bit_depth: int) -> torch.Tensor:
    ops.check_cuda_i32("intra_pred_all", c_batch)
    n = c_batch.shape[0]
    if c_batch.dim() != 2 or c_batch.shape[1] != 4 * size + 3:
        raise ValueError(f"intra_pred_all: refs {tuple(c_batch.shape)} "
                         f"are not [N, {4 * size + 3}]")
    if size not in (4, 8, 16, 32, 64):
        raise ValueError(f"intra_pred_all: unsupported size {size}")
    idx, co, W, I, diff, _ = _device_tables(size, str(c_batch.device))
    out = torch.empty((n, 67, size, size), dtype=torch.int32,
                      device=c_batch.device)
    fn = ops.lib("intra_pred_all").intra_pred_all_launch
    fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 4
                   + [ctypes.c_void_p] * 7)
    fn.restype = ctypes.c_int
    err = fn(c_batch.data_ptr(), n, size, int(np.log2(size)), bit_depth,
             idx.data_ptr(), co.data_ptr(), W.data_ptr(), I.data_ptr(),
             diff.data_ptr(), out.data_ptr(), ops.stream_ptr(c_batch))
    ops.launched("intra_pred_all", err)
    return out


def predict_all_modes_batch(c_batch: torch.Tensor, size: int,
                            bit_depth: int = 8) -> torch.Tensor:
    """[N, 4S+3] reference lines → [N, 67, S, S] int32 predictions for all
    modes (mode axis = mode index: 0 planar, 1 DC, 2..66 angular).

    Port of vvc/kernels/intra.py:671.  CUDA tensor → the CUDA kernel
    (vvc_torch/csrc/intra_pred.cu); CPU tensor or `ops.plain()` → the plain
    PyTorch version."""
    if ops.use_kernel(c_batch):
        return _predict_all_cuda(c_batch, size, bit_depth)
    return predict_all_modes_batch_plain(c_batch, size, bit_depth)


# ---------------------------------------------------------------------------
# One mode per block — the RD search's chroma DM prediction
# ---------------------------------------------------------------------------


def predict_modes_batch_plain(c_batch: torch.Tensor, modes: torch.Tensor,
                              size: int, bit_depth: int = 8) -> torch.Tensor:
    """Plain twin of vvc/kernels/intra.py:878 predict_modes_batch: [N, 4S+3]
    int32 lines + [N] int32 modes → [N,S,S] int32.  Each block gathers its
    own mode's table row; the rows are clamped as vvc clamps them
    (mv = clip(m−34, 0, 32), mh = clip(34−m, 0, 32))."""
    s = size
    n = c_batch.shape[0]
    idx, co, W, I, diff, wl = _device_tables(s, str(c_batch.device))
    c = c_batch.to(torch.int32)
    modes = modes.to(torch.int64)
    mv = (modes - DIA_IDX).clamp(0, 32)
    mh = (68 - modes - DIA_IDX).clamp(0, 32)

    def angular_row(line, rows):
        g = line.gather(1, idx[rows].reshape(n, -1).long()).reshape(n, 4, s, s)
        p = ((co[rows] * g).sum(1) + 32) >> 6
        ref = line.gather(1, I[rows].reshape(n, -1).long()).reshape(n, s, s)
        corner = line[:, 2 * s][:, None, None]
        wj = W[rows]
        return p + torch.where(diff[rows].bool()[:, None, None],
                               (wj * (ref - corner)) >> 6,
                               (wj * (ref - p) + 32) >> 6)

    planar, dc_pred = _planar_dc_plain(c, s, wl)
    pv = angular_row(c, mv)
    ph = angular_row(_reversed_line(c, s), mh).transpose(1, 2)
    m3 = modes[:, None, None]
    ang = torch.where(m3 >= DIA_IDX, pv, ph)
    out = torch.where(m3 == PLANAR_IDX, planar,
                      torch.where(m3 == DC_IDX, dc_pred, ang))
    return out.clamp(0, (1 << bit_depth) - 1).to(torch.int32)


def _predict_one_cuda(c_batch: torch.Tensor, modes: torch.Tensor, size: int,
                      bit_depth: int) -> torch.Tensor:
    ops.check_cuda_i32("intra_pred_one", c_batch, modes)
    n = c_batch.shape[0]
    if c_batch.dim() != 2 or c_batch.shape[1] != 4 * size + 3:
        raise ValueError(f"intra_pred_one: refs {tuple(c_batch.shape)} "
                         f"are not [N, {4 * size + 3}]")
    if modes.shape != (n,):
        raise ValueError("intra_pred_one: modes must be [N]")
    if size not in (4, 8, 16, 32, 64):
        raise ValueError(f"intra_pred_one: unsupported size {size}")
    idx, co, W, I, diff, _ = _device_tables(size, str(c_batch.device))
    out = torch.empty((n, size, size), dtype=torch.int32,
                      device=c_batch.device)
    fn = ops.lib("intra_pred_one").intra_pred_one_launch
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p] * 7)
    fn.restype = ctypes.c_int
    err = fn(c_batch.data_ptr(), modes.data_ptr(), n, size,
             int(np.log2(size)), bit_depth, idx.data_ptr(), co.data_ptr(),
             W.data_ptr(), I.data_ptr(), diff.data_ptr(), out.data_ptr(),
             ops.stream_ptr(c_batch))
    ops.launched("intra_pred_one", err)
    return out


def predict_modes_batch(c_batch: torch.Tensor, modes: torch.Tensor,
                        size: int, bit_depth: int = 8) -> torch.Tensor:
    """[N, 4S+3] reference lines + [N] int32 modes → [N, S, S] int32, the
    prediction of each block's own mode.

    Port of vvc/kernels/intra.py:878.  CUDA tensor → the CUDA kernel
    `intra_pred_one` (vvc_torch/csrc/intra_pred.cu); CPU tensor or
    `ops.plain()` → predict_modes_batch_plain."""
    if ops.use_kernel(c_batch):
        return _predict_one_cuda(c_batch, modes, size, bit_depth)
    return predict_modes_batch_plain(c_batch, modes, size, bit_depth)


# ---------------------------------------------------------------------------
# Rectangular blocks (the MTT lattice's shapes and the ISP sub-TUs): all
# 67 modes per block, or one mode per block, with the wide-angle remap
# folded into static tables
# ---------------------------------------------------------------------------


_EXT_MODES = tuple(range(DIA_IDX, 83))      # vertical family, wide included


@lru_cache(maxsize=None)
def _rect_row_tables(w: int, h: int):
    """The 49-row tables of vvc/kernels/intra.py:822 predict_modes_batch_rect
    (row r = extended vertical mode 34 + r): remap [67] (signaled mode →
    remapped mode), the vertical family's 4-tap idx/co [49,4,H,W] and PDPC
    W/I [49,H,W], diff [49] in the W×H geometry, and the horizontal
    family's [49,4,W,H], [49,W,H], [49] in the transposed geometry."""
    remap = np.array([wide_angle_remap(m, w, h) if m >= 2 else m
                      for m in range(67)], dtype=np.int32)
    vt = [angular_tables4_rect(w, h, vm) for vm in _EXT_MODES]
    ht = [angular_tables4_rect(h, w, vm) for vm in _EXT_MODES]
    vW, vI, vD = _stacked_pdpc(w, h, _EXT_MODES)
    hW, hI, hD = _stacked_pdpc(h, w, _EXT_MODES)
    return (remap, np.stack([t[0] for t in vt]), np.stack([t[1] for t in vt]),
            vW, vI, vD, np.stack([t[0] for t in ht]),
            np.stack([t[1] for t in ht]), hW, hI, hD)


@lru_cache(maxsize=None)
def _rect_device_tables(w: int, h: int, device: str):
    return tuple(torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)
                                  ).to(device)
                 for a in _rect_row_tables(w, h))


def _planar_dc_rect_plain(c: torch.Tensor, w: int, h: int):
    """Planar and DC (+PDPC) of [N, 2H+2W+3] int32 lines → two [N,H,W]
    int32 tensors, unclipped (vvc/kernels/intra.py:763)."""
    log2w, log2h = int(np.log2(w)), int(np.log2(h))
    n = c.shape[0]
    left = c[:, :2 * h].flip(1)
    top = c[:, 2 * h + 1:2 * h + 2 * w + 1]
    xs = torch.arange(w, dtype=torch.int32, device=c.device)
    ys = torch.arange(h, dtype=torch.int32, device=c.device)
    below_left = left[:, h][:, None, None]
    above_right = top[:, w][:, None, None]
    pred_v = ((h - 1 - ys)[None, :, None] * top[:, None, :w]
              + (ys + 1)[None, :, None] * below_left) << log2w
    pred_h = ((w - 1 - xs)[None, None, :] * left[:, :h, None]
              + (xs + 1)[None, None, :] * above_right) << log2h
    planar = (pred_v + pred_h + w * h) >> (log2w + log2h + 1)
    if w == h:
        dc = (top[:, :w].sum(1) + left[:, :h].sum(1) + w) >> (log2w + 1)
    elif w > h:
        dc = (top[:, :w].sum(1) + (w >> 1)) >> log2w
    else:
        dc = (left[:, :h].sum(1) + (h >> 1)) >> log2h
    dc_pred = dc[:, None, None].expand(n, h, w)
    scale = (log2w + log2h - 2) >> 2
    wl = (32 >> ((2 * xs) >> scale).clamp(max=31))[None, None, :]
    wt = (32 >> ((2 * ys) >> scale).clamp(max=31))[None, :, None]
    lcol = left[:, :h, None]
    trow = top[:, None, :w]

    def pdpc(p):
        return (wl * lcol + wt * trow + (64 - wl - wt) * p + 32) >> 6

    return pdpc(planar), pdpc(dc_pred)


def _reversed_line_rect(c: torch.Tensor, w: int, h: int) -> torch.Tensor:
    """ct: the rect line reversed about its corner, padded like vvc's."""
    head = c[:, :2 * h + 2 * w + 1].flip(1)
    return torch.cat([head, head[:, -1:], head[:, -1:]], dim=1)


def _angular_pdpc(p, line, W, I, diff, hv: int):
    """Angular PDPC of v-space predictions p [..., hv, wv] from `line`."""
    ref = line.gather(1, I.reshape(I.shape[0], -1).long()).reshape(I.shape)
    corner = line[:, 2 * hv].reshape((-1,) + (1,) * (p.dim() - 1))
    return p + torch.where(diff.bool(), (W * (ref - corner)) >> 6,
                           (W * (ref - p) + 32) >> 6)


def predict_all_modes_batch_rect_plain(c_batch: torch.Tensor, w: int, h: int,
                                       bit_depth: int = 8) -> torch.Tensor:
    """Plain twin of vvc/kernels/intra.py:799 predict_all_modes_batch_rect:
    [N, 2H+2W+3] int32 lines → [N, 67, H, W] int32 — the one-mode twin
    below at every mode of every block (vvc's stacked tables hold the same
    rows, grouped by family)."""
    n = c_batch.shape[0]
    modes = torch.arange(67, dtype=torch.int32,
                         device=c_batch.device).repeat(n)
    out = predict_modes_batch_rect_plain(c_batch.repeat_interleave(67, 0),
                                         modes, w, h, bit_depth)
    return out.reshape(n, 67, h, w)


def predict_modes_batch_rect_plain(c_batch: torch.Tensor,
                                   modes: torch.Tensor, w: int, h: int,
                                   bit_depth: int = 8) -> torch.Tensor:
    """Plain twin of vvc/kernels/intra.py:822 predict_modes_batch_rect:
    [N, 2H+2W+3] int32 lines + [N] int32 modes → [N,H,W] int32.  Both
    families are computed from each block's own table row (clipped to
    0..48 as vvc clips it) and selected by the remapped family.  A mode
    outside 0..66 predicts as the nearest of them, as the kernel does."""
    n = c_batch.shape[0]
    (remap, vi, vc, vW, vI, vD, hi, hc, hW, hI,
     hD) = _rect_device_tables(w, h, str(c_batch.device))
    c = c_batch.to(torch.int32)
    modes = modes.to(torch.int64).clamp(0, 66)
    planar, dc_pred = _planar_dc_rect_plain(c, w, h)
    rm = remap.long()[modes]
    rv = (rm - DIA_IDX).clamp(0, 48)
    rh = (68 - rm - DIA_IDX).clamp(0, 48)

    def row(line, rows, ti, tc, tW, tI, tD, wv, hv):
        g = line.gather(1, ti[rows].reshape(n, -1).long()).reshape(
            n, 4, hv, wv)
        p = ((tc[rows] * g).sum(1) + 32) >> 6
        return _angular_pdpc(p, line, tW[rows], tI[rows],
                             tD[rows][:, None, None], hv)

    pv = row(c, rv, vi, vc, vW, vI, vD, w, h)
    ph = row(_reversed_line_rect(c, w, h), rh, hi, hc, hW, hI, hD, h,
             w).transpose(1, 2)
    ang = torch.where((rm >= DIA_IDX)[:, None, None], pv, ph)
    m3 = modes[:, None, None]
    out = torch.where(m3 == PLANAR_IDX, planar,
                      torch.where(m3 == DC_IDX, dc_pred, ang))
    return out.clamp(0, (1 << bit_depth) - 1).to(torch.int32)


def _rect_args(name: str, c_batch: torch.Tensor, w: int, h: int):
    n = c_batch.shape[0]
    if c_batch.dim() != 2 or c_batch.shape[1] != 2 * h + 2 * w + 3:
        raise ValueError(f"{name}: refs {tuple(c_batch.shape)} are not "
                         f"[N, {2 * h + 2 * w + 3}]")
    sides = (4, 8, 16, 32, 64)
    if w not in sides or h not in sides:
        raise ValueError(f"{name}: unsupported block {w}x{h}")
    return n, _rect_device_tables(w, h, str(c_batch.device))


def _predict_all_rect_cuda(c_batch: torch.Tensor, w: int, h: int,
                           bit_depth: int) -> torch.Tensor:
    ops.check_cuda_i32("intra_pred_all_rect", c_batch)
    n, tabs = _rect_args("intra_pred_all_rect", c_batch, w, h)
    out = torch.empty((n, 67, h, w), dtype=torch.int32,
                      device=c_batch.device)
    fn = ops.lib("intra_pred_all_rect").intra_pred_all_rect_launch
    # refs, n, w, h, bit depth, the 11 tables, out, stream
    fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 4
                   + [ctypes.c_void_p] * (len(tabs) + 2))
    fn.restype = ctypes.c_int
    err = fn(c_batch.data_ptr(), n, w, h, bit_depth,
             *(t.data_ptr() for t in tabs), out.data_ptr(),
             ops.stream_ptr(c_batch))
    ops.launched("intra_pred_all_rect", err)
    return out


def predict_all_modes_batch_rect(c_batch: torch.Tensor, w: int, h: int,
                                 bit_depth: int = 8) -> torch.Tensor:
    """[N, 2H+2W+3] rect reference lines → [N, 67, H, W] int32 predictions
    for every signaled mode (wide-angle remap folded into the tables).
    Port of vvc/kernels/intra.py:799; W == H is predict_all_modes_batch.
    CUDA tensor → `intra_pred_all_rect` (vvc_torch/csrc/intra_pred.cu);
    CPU tensor or `ops.plain()` → predict_all_modes_batch_rect_plain."""
    if w == h:
        return predict_all_modes_batch(c_batch, w, bit_depth)
    if ops.use_kernel(c_batch):
        return _predict_all_rect_cuda(c_batch, w, h, bit_depth)
    return predict_all_modes_batch_rect_plain(c_batch, w, h, bit_depth)


def _predict_one_rect_cuda(c_batch: torch.Tensor, modes: torch.Tensor,
                           w: int, h: int, bit_depth: int) -> torch.Tensor:
    ops.check_cuda_i32("intra_pred_one_rect", c_batch, modes)
    n, tabs = _rect_args("intra_pred_one_rect", c_batch, w, h)
    if modes.shape != (n,):
        raise ValueError("intra_pred_one_rect: modes must be [N]")
    out = torch.empty((n, h, w), dtype=torch.int32, device=c_batch.device)
    fn = ops.lib("intra_pred_one_rect").intra_pred_one_rect_launch
    # refs, modes, n, w, h, bit depth, the 11 tables, out, stream
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p] * (len(tabs) + 2))
    fn.restype = ctypes.c_int
    err = fn(c_batch.data_ptr(), modes.data_ptr(), n, w, h, bit_depth,
             *(t.data_ptr() for t in tabs), out.data_ptr(),
             ops.stream_ptr(c_batch))
    ops.launched("intra_pred_one_rect", err)
    return out


def predict_modes_batch_rect(c_batch: torch.Tensor, modes: torch.Tensor,
                             w: int, h: int,
                             bit_depth: int = 8) -> torch.Tensor:
    """[N, 2H+2W+3] rect reference lines + [N] int32 modes → [N, H, W]
    int32, each block's own mode (the ISP sub-TUs of the RD search).  Port
    of vvc/kernels/intra.py:822.  CUDA tensor → `intra_pred_one_rect`
    (vvc_torch/csrc/intra_pred.cu); CPU tensor or `ops.plain()` →
    predict_modes_batch_rect_plain."""
    if ops.use_kernel(c_batch):
        return _predict_one_rect_cuda(c_batch, modes, w, h, bit_depth)
    return predict_modes_batch_rect_plain(c_batch, modes, w, h, bit_depth)

"""CCLM — cross-component linear model chroma prediction.

TPU-native analog of the reference's CCLM
(`VTM/source/Lib/CommonLib/IntraPrediction.cpp` →
predIntraChromaLM / xGetLumaRecPixels (6-tap 4:2:0 downsample) and the
min/max model derivation).  SURVEY.md §2.2: "CCLM = reduction + per-block
affine".

Model: chroma = clip( (α · lumaDS) >> SHIFT + β ) with (α, β) derived
from up to 4 (lumaDS, chroma) neighbour pairs — the two smallest-luma and
two largest-luma points (spec 8.4.5.2.13 method).  [verify]: the spec
computes the division through a 16-entry LUT; we use exact integer
division (self-consistent between encoder and decoder).  Variants
(chroma_mode): 1 = LM (both sides), 2 = LM_L (left-only derivation),
3 = LM_T (top-only) — reference MDLM_L/MDLM_T, simplified to the block's
own boundary extent ([verify] spec extends the boundary to 2x).

The 6-tap downsampled luma plane is computed vectorized once per call
site; the C++ recon core mirrors the same per-sample formula bit-exactly.
"""
from __future__ import annotations

import numpy as np

CCLM_SHIFT = 13


def luma_ds_plane(luma: np.ndarray) -> np.ndarray:
    """[H,W] luma → [H/2, W/2] 6-tap {1,2,1;1,2,1}/8 downsample,
    edge-clamped columns."""
    h, w = luma.shape
    l = luma.astype(np.int32)
    xm = np.clip(np.arange(0, w, 2) - 1, 0, w - 1)
    x0 = np.arange(0, w, 2)
    xp = np.clip(np.arange(0, w, 2) + 1, 0, w - 1)
    r0 = l[0::2]
    r1 = l[1::2] if h % 2 == 0 else np.vstack([l[1::2], l[-1:]])
    return ((r0[:, xm] + 2 * r0[:, x0] + r0[:, xp]
             + r1[:, xm] + 2 * r1[:, x0] + r1[:, xp] + 4) >> 3)


def luma_ds_region(luma: np.ndarray, cx0: int, cy0: int, cw: int,
                   ch: int) -> np.ndarray:
    """Region-local twin of luma_ds_plane: the [ch, cw] downsampled patch
    whose top-left is chroma position (cx0, cy0).  Lets the sequential
    recon refresh only a leaf's neighbourhood instead of re-downsampling
    the whole plane per CCLM leaf (O(leaf) instead of O(frame))."""
    h, w = luma.shape
    l = luma.astype(np.int32)
    cx = np.arange(cx0, cx0 + cw)
    xm = np.clip(2 * cx - 1, 0, w - 1)
    x0 = np.clip(2 * cx, 0, w - 1)
    xp = np.clip(2 * cx + 1, 0, w - 1)
    cy = np.arange(cy0, cy0 + ch)
    y0 = np.clip(2 * cy, 0, h - 1)
    y1 = np.clip(2 * cy + 1, 0, h - 1)
    r0 = l[y0]
    r1 = l[y1]
    return ((r0[:, xm] + 2 * r0[:, x0] + r0[:, xp]
             + r1[:, xm] + 2 * r1[:, x0] + r1[:, xp] + 4) >> 3)


def gather_model_points(ds: np.ndarray, chroma: np.ndarray, coded_c,
                        cx0: int, cy0: int, cs: int, log2_unit=2,
                        variant: int = 1):
    """Up to 4 (lumaDS, chroma) neighbour pairs for a chroma block.
    variant: 1 = LM (both sides), 2 = LM_L (left only), 3 = LM_T (top
    only)."""
    ch, cw = chroma.shape
    pts = []

    def avail(px, py):
        return (0 <= px < cw and 0 <= py < ch
                and bool(coded_c[py >> log2_unit, px >> log2_unit]))

    top_ok = (cy0 > 0 and avail(cx0, cy0 - 1)) and variant != 2
    left_ok = (cx0 > 0 and avail(cx0 - 1, cy0)) and variant != 3
    if top_ok and left_ok:
        xs = [cx0 + cs // 4, cx0 + (3 * cs) // 4]
        ys = [cy0 + cs // 4, cy0 + (3 * cs) // 4]
    elif top_ok:
        xs = [cx0 + k * cs // 4 for k in range(4)]
        ys = []
    elif left_ok:
        xs = []
        ys = [cy0 + k * cs // 4 for k in range(4)]
    else:
        return []
    for x in xs:
        x = min(x, cw - 1)
        if avail(x, cy0 - 1):
            pts.append((int(ds[cy0 - 1, x]), int(chroma[cy0 - 1, x])))
    for y in ys:
        y = min(y, ch - 1)
        if avail(cx0 - 1, y):
            pts.append((int(ds[y, cx0 - 1]), int(chroma[y, cx0 - 1])))
    return pts[:4]


def derive_model(pts, bit_depth: int):
    """(α fixed-point CCLM_SHIFT, β) from sample pairs (min/max method)."""
    if not pts:
        return 0, 1 << (bit_depth - 1)
    while len(pts) < 4:
        pts = pts + pts
    pts = sorted(pts[:4], key=lambda p: p[0])
    lmin = (pts[0][0] + pts[1][0] + 1) >> 1
    lmax = (pts[2][0] + pts[3][0] + 1) >> 1
    cmin = (pts[0][1] + pts[1][1] + 1) >> 1
    cmax = (pts[2][1] + pts[3][1] + 1) >> 1
    if lmax == lmin:
        return 0, cmin
    num = (cmax - cmin) << CCLM_SHIFT
    den = lmax - lmin
    # floor division toward -inf on both sides (python // semantics; the
    # C++ core reproduces this explicitly)
    alpha = num // den
    alpha = max(-(1 << 17), min((1 << 17) - 1, alpha))
    beta = cmin - ((alpha * lmin) >> CCLM_SHIFT)
    return alpha, beta


def derive_models_batch(ds: np.ndarray, chroma: np.ndarray,
                        xs: np.ndarray, ys: np.ndarray, cs: int,
                        bit_depth: int, variant: int = 1):
    """Vectorized (α, β) for N same-size chroma blocks, assuming all
    inside-frame neighbours available (the encoder's orig-domain decision
    approximation — reconstruction re-derives exactly per leaf).

    Returns int64 [N, 2] (alpha, beta)."""
    n = len(xs)
    ch, cw = chroma.shape
    top_ok = (ys > 0) & (variant != 2)
    left_ok = (xs > 0) & (variant != 3)
    # 4 sample points per block: both → 2 top + 2 left; top-only → 4 top;
    # left-only → 4 left (mirrors gather_model_points)
    k = np.arange(4)
    x_top = np.where(top_ok[:, None] & left_ok[:, None],
                     xs[:, None] + np.array([cs // 4, 3 * cs // 4,
                                             cs // 4, 3 * cs // 4]),
                     xs[:, None] + k[None, :] * cs // 4)
    y_left = np.where(top_ok[:, None] & left_ok[:, None],
                      ys[:, None] + np.array([0, 0, cs // 4, 3 * cs // 4]),
                      ys[:, None] + k[None, :] * cs // 4)
    # per point: from top row (y-1, x_top) or left col (x-1, y_left)
    use_top = np.where((top_ok & left_ok)[:, None],
                       np.array([1, 1, 0, 0], dtype=bool)[None, :],
                       np.broadcast_to(top_ok[:, None], (n, 4)))
    px = np.where(use_top, np.minimum(x_top, cw - 1),
                  np.maximum(xs - 1, 0)[:, None])
    py = np.where(use_top, np.maximum(ys - 1, 0)[:, None],
                  np.minimum(y_left, ch - 1))
    lum = ds[py, px].astype(np.int64)
    chr_ = chroma[py, px].astype(np.int64)
    order = np.argsort(lum, axis=1, kind="stable")
    lum = np.take_along_axis(lum, order, axis=1)
    chr_ = np.take_along_axis(chr_, order, axis=1)
    lmin = (lum[:, 0] + lum[:, 1] + 1) >> 1
    lmax = (lum[:, 2] + lum[:, 3] + 1) >> 1
    cmin = (chr_[:, 0] + chr_[:, 1] + 1) >> 1
    cmax = (chr_[:, 2] + chr_[:, 3] + 1) >> 1
    den = lmax - lmin
    alpha = np.where(den != 0,
                     ((cmax - cmin) << CCLM_SHIFT) // np.maximum(den, 1), 0)
    alpha = np.clip(alpha, -(1 << 17), (1 << 17) - 1)
    beta = np.where(den != 0, cmin - ((alpha * lmin) >> CCLM_SHIFT), cmin)
    none_ok = ~top_ok & ~left_ok
    alpha = np.where(none_ok, 0, alpha)
    beta = np.where(none_ok, 1 << (bit_depth - 1), beta)
    return np.stack([alpha, beta], axis=1)


def predict_cclm(ds: np.ndarray, chroma: np.ndarray, coded_c, cx0: int,
                 cy0: int, cs: int, bit_depth: int, log2_unit=2,
                 variant: int = 1):
    """CCLM prediction for one chroma block from the downsampled-luma
    plane `ds` (numpy oracle)."""
    pts = gather_model_points(ds, chroma, coded_c, cx0, cy0, cs, log2_unit,
                              variant)
    alpha, beta = derive_model(pts, bit_depth)
    blk = ds[cy0:cy0 + cs, cx0:cx0 + cs].astype(np.int64)
    pred = (alpha * blk >> CCLM_SHIFT) + beta
    return np.clip(pred, 0, (1 << bit_depth) - 1).astype(np.int32)

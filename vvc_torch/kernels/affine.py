"""Affine motion: subblock-MV derivation, prediction, PROF.

Copy of the numpy half of vvc/kernels/affine.py (:46-251), which the
motion field, deblocking's boundary strengths and the batched MC import
even with affine off.  The batched affine ME (`affine_me_batch`,
`_affine_me_jit`, JAX programs with no live caller) is not copied.

TPU-native analog of the reference's affine stack
(`VTM/source/Lib/CommonLib/InterPrediction.cpp` →
InterPrediction::xPredAffineBlk — 4×4 subblock MVs from 2/3 control-point
MVs + PROF optical-flow refinement; EncoderLib/InterSearch.cpp →
xPredAffineInterSearch / xAffineMotionEstimation — gradient least-squares
CPMV refinement; AffineGradientSearch.cpp).

TPU-first design notes (SURVEY.md §7.0):
  - The reference refines CPMVs per block with a sequential Gauss-Newton
    loop over hand-unrolled gradient sums.  Here the SAME math runs as a
    fixed-iteration batched solve over EVERY candidate block of a size
    class at once: gradients are full-tensor ops, the 4/6-param normal
    equations are tiny batched matrices solved with `jnp.linalg.solve`
    (one fused device program; no per-block host loop).
  - Subblock MC in the normative path is vectorized over subblocks with
    per-subblock phase filters (gather + 8-tap separable filter batched
    on the tap axis), not a per-subblock scalar loop.

Fixed-point model (self-consistent; both codec halves share it, which is
what bit-exactness rests on — deviations from the spec's 1/16-pel
internals are documented in vvc_torch/kernels/mc.py):
  - CPMVs are stored in luma 1/4-pel like every other MV.
  - Per-subblock MVs are derived in (1/4-pel << AFF_SHIFT) fixed point
    and rounded back to 1/4-pel: the derivation gradient for a CU of
    width w is dX = (cpmv1 - cpmv0) << AFF_SHIFT >> log2(w)
    (reference: iDMvHorX = (mv1 - mv0) << (MAX_CU_DEPTH - log2w)).
  - PROF refines per-sample in the same fixed point: dv(x, y) relative to
    the subblock centre, ΔI = (gx·dvx + gy·dvy) >> (AFF_SHIFT + 2), with
    the +2 converting 1/4-pel to integer-pel gradient units.
"""
from __future__ import annotations

import numpy as np

from vvc_torch.kernels.mc import LUMA_FILTERS, CHROMA_FILTERS

AFF_SHIFT = 7          # subblock-MV derivation fixed point above 1/4-pel
SB = 4                 # luma subblock size
PROF_CLIP = 1 << 13    # ΔI clamp (reference: dILimit = 1 << max(13, bd+1))


def _round_fp(v, s: int):
    """Symmetric round of an AFF_SHIFT fixed-point value (works on numpy
    arrays and python ints; matches the reference's roundAffineMv)."""
    v = np.asarray(v)
    off = (1 << (s - 1))
    return np.where(v >= 0, (v + off) >> s, -((-v + off) >> s)).astype(
        np.int64)


def affine_mv_grid(w: int, h: int, cpmv, n_params: int):
    """Per-4×4-subblock MV grid [h//4, w//4, 2] in 1/4-pel from control
    points.  cpmv: ((x,y), (x,y)[, (x,y)]) at corners TL, TR[, BL].

    Reference: InterPrediction::xPredAffineBlk subblock-centre evaluation
    at (4i+2, 4j+2)."""
    (m0x, m0y), (m1x, m1y) = cpmv[0], cpmv[1]
    lw = int(w).bit_length() - 1
    lh = int(h).bit_length() - 1
    dhx = ((m1x - m0x) << AFF_SHIFT) >> lw
    dhy = ((m1y - m0y) << AFF_SHIFT) >> lw
    if n_params == 6:
        m2x, m2y = cpmv[2]
        dvx = ((m2x - m0x) << AFF_SHIFT) >> lh
        dvy = ((m2y - m0y) << AFF_SHIFT) >> lh
    else:                       # 4-param: rotation/zoom ties the axes
        dvx = -dhy
        dvy = dhx
    cx = np.arange(w // SB, dtype=np.int64) * SB + SB // 2
    cy = np.arange(h // SB, dtype=np.int64) * SB + SB // 2
    bx = (m0x << AFF_SHIFT) + dhx * cx[None, :] + dvx * cy[:, None]
    by = (m0y << AFF_SHIFT) + dhy * cx[None, :] + dvy * cy[:, None]
    mv = np.stack([_round_fp(bx, AFF_SHIFT), _round_fp(by, AFF_SHIFT)],
                  axis=-1)
    return np.clip(mv, -(1 << 17), (1 << 17) - 1).astype(np.int32)


def _affine_deltas(w: int, h: int, cpmv, n_params: int):
    """(dhx, dhy, dvx, dvy) derivation gradients in AFF_SHIFT fixed point
    per 1-luma-sample step (shared by grid derivation and PROF)."""
    (m0x, m0y), (m1x, m1y) = cpmv[0], cpmv[1]
    lw = int(w).bit_length() - 1
    lh = int(h).bit_length() - 1
    dhx = ((m1x - m0x) << AFF_SHIFT) >> lw
    dhy = ((m1y - m0y) << AFF_SHIFT) >> lw
    if n_params == 6:
        m2x, m2y = cpmv[2]
        dvx = ((m2x - m0x) << AFF_SHIFT) >> lh
        dvy = ((m2y - m0y) << AFF_SHIFT) >> lh
    else:
        dvx, dvy = -dhy, dhx
    return dhx, dhy, dvx, dvy


def _gather_batched(plane: np.ndarray, bx, by, out: int, taps: int):
    """Clamped gather of [N, out+taps-1, out+taps-1] filter windows whose
    per-item integer top-left is (bx[k], by[k])."""
    half = taps // 2 - 1
    ph, pw = plane.shape
    span = out + taps - 1
    k = np.arange(span)
    ys = np.clip(by[:, None] - half + k[None, :], 0, ph - 1)
    xs = np.clip(bx[:, None] - half + k[None, :], 0, pw - 1)
    return plane[ys[:, :, None], xs[:, None, :]]


def _filter_batched(win: np.ndarray, fh: np.ndarray, fv: np.ndarray,
                    out: int):
    """Per-item separable filter: win [N, out+T-1, out+T-1], fh/fv [N, T]
    per-item coefficient rows.  Returns the raw gain-4096 accumulator."""
    win = win.astype(np.int64)
    taps = fh.shape[1]
    tmp = np.zeros((win.shape[0], win.shape[1], out), dtype=np.int64)
    for t in range(taps):
        tmp += fh[:, t, None, None] * win[:, :, t:t + out]
    res = np.zeros((win.shape[0], out, out), dtype=np.int64)
    for t in range(taps):
        res += fv[:, t, None, None] * tmp[:, t:t + out, :]
    return res


def affine_pred_np(plane: np.ndarray, x0: int, y0: int, w: int, h: int,
                   cpmv, n_params: int, bit_depth: int,
                   chroma: bool = False, prof: bool = False) -> np.ndarray:
    """Normative affine prediction of an (h, w) block at (x0, y0).

    Luma: 4×4 subblocks at the derived MV grid; optional PROF.  Chroma
    (half-res plane; x0/y0/w/h already in chroma samples): one 4×4 chroma
    subblock per 2×2 luma subblocks, MV = average of the two diagonal luma
    subblock MVs (reference: xPredAffineBlk chroma path), applied at
    1/8-pel.  Returns int32 clipped to bit depth."""
    if chroma:
        grid = affine_mv_grid(w * 2, h * 2, cpmv, n_params).astype(np.int64)
        # average the diagonal pair of each 2×2 luma-subblock group
        a = grid[0::2, 0::2]
        b = grid[1::2, 1::2]
        mv = _round_fp((a + b) << (AFF_SHIFT - 1), AFF_SHIFT).astype(
            np.int32)                           # = round((a+b)/2)
        filt, taps, fbits = CHROMA_FILTERS, 4, 3
    else:
        mv = affine_mv_grid(w, h, cpmv, n_params)
        filt, taps, fbits = LUMA_FILTERS, 8, 2
    nby, nbx = mv.shape[:2]
    mvx = mv[..., 0].ravel()
    mvy = mv[..., 1].ravel()
    sx = x0 + (np.tile(np.arange(nbx), nby) * SB)
    sy = y0 + (np.repeat(np.arange(nby), nbx) * SB)
    out = SB + 2 if (prof and not chroma) else SB
    off = 1 if (prof and not chroma) else 0
    ix, fx = mvx >> fbits, mvx & ((1 << fbits) - 1)
    iy, fy = mvy >> fbits, mvy & ((1 << fbits) - 1)
    win = _gather_batched(plane, sx + ix - off, sy + iy - off, out, taps)
    acc = _filter_batched(win, filt[fx], filt[fy], out)
    pred = (acc + 2048) >> 12                           # gain 64·64 → unit
    if prof and not chroma:
        pred = _prof_refine(pred, w, h, cpmv, n_params)
    pred = np.clip(pred, 0, (1 << bit_depth) - 1).astype(np.int32)
    return (pred.reshape(nby, nbx, SB, SB).transpose(0, 2, 1, 3)
            .reshape(nby * SB, nbx * SB))


def _prof_refine(pred_ext: np.ndarray, w: int, h: int, cpmv,
                 n_params: int) -> np.ndarray:
    """PROF: per-sample optical-flow refinement of the (SB+2)² extended
    subblock predictions → refined SB² subblocks [N, SB, SB].

    dv(x, y) is the AFF_SHIFT fixed-point difference between the affine MV
    at sample (x, y) and the subblock-centre MV — identical for every
    subblock, so it is computed once (reference: xPredAffineBlk dMvScaleHor).
    """
    dhx, dhy, dvx, dvy = _affine_deltas(w, h, cpmv, n_params)
    # sample offsets from the subblock centre (centre at (1.5, 1.5)): use
    # half-sample fixed point (×2) to stay integer: 2·(p − 1.5) = 2p − 3
    p = np.arange(SB, dtype=np.int64) * 2 - 3
    dvx_s = (dhx * p[None, :] + dvx * p[:, None]) >> 1     # [SB, SB]
    dvy_s = (dhy * p[None, :] + dvy * p[:, None]) >> 1
    g = pred_ext.astype(np.int64)
    gx = (g[:, 1:SB + 1, 2:SB + 2] - g[:, 1:SB + 1, 0:SB]) >> 1
    gy = (g[:, 2:SB + 2, 1:SB + 1] - g[:, 0:SB, 1:SB + 1]) >> 1
    di = (gx * dvx_s[None] + gy * dvy_s[None]
          + (1 << (AFF_SHIFT + 1))) >> (AFF_SHIFT + 2)
    di = np.clip(di, -PROF_CLIP, PROF_CLIP - 1)
    return pred_ext[:, 1:SB + 1, 1:SB + 1] + di


def prof_worth_it(cpmv, n_params: int) -> bool:
    """PROF is skipped when the CU degenerates to translation (all deltas
    zero) — reference: xPredAffineBlk PROF early-out."""
    d = _affine_deltas(64, 64, cpmv, n_params)
    return any(int(x) != 0 for x in d)


def affine_mv_grid_batch(size: int, cpmvs: np.ndarray, n_params: int):
    """Vectorized affine_mv_grid for N same-size square blocks.

    cpmvs [N, 3, 2] int (TL, TR, BL; BL ignored for 4-param).  Returns
    [N, size//4, size//4, 2] 1/4-pel subblock MVs — identical per block to
    affine_mv_grid (the normative scalar path)."""
    cp = cpmvs.astype(np.int64)
    lw = int(size).bit_length() - 1
    dhx = ((cp[:, 1, 0] - cp[:, 0, 0]) << AFF_SHIFT) >> lw
    dhy = ((cp[:, 1, 1] - cp[:, 0, 1]) << AFF_SHIFT) >> lw
    if n_params == 6:
        dvx = ((cp[:, 2, 0] - cp[:, 0, 0]) << AFF_SHIFT) >> lw
        dvy = ((cp[:, 2, 1] - cp[:, 0, 1]) << AFF_SHIFT) >> lw
    else:
        dvx, dvy = -dhy, dhx
    c = np.arange(size // SB, dtype=np.int64) * SB + SB // 2
    bx = ((cp[:, 0, 0] << AFF_SHIFT)[:, None, None]
          + dhx[:, None, None] * c[None, None, :]
          + dvx[:, None, None] * c[None, :, None])
    by = ((cp[:, 0, 1] << AFF_SHIFT)[:, None, None]
          + dhy[:, None, None] * c[None, None, :]
          + dvy[:, None, None] * c[None, :, None])
    mv = np.stack([_round_fp(bx, AFF_SHIFT), _round_fp(by, AFF_SHIFT)],
                  axis=-1)
    return np.clip(mv, -(1 << 17), (1 << 17) - 1).astype(np.int32)


def affine_pred_batch_np(plane: np.ndarray, xs, ys, size: int,
                         cpmvs: np.ndarray, n_params: int,
                         bit_depth: int) -> np.ndarray:
    """Normative (PROF-less) affine luma prediction of N same-size square
    blocks at origins (xs, ys) with per-block CPMVs [N, 3, 2].  The ME uses
    this to score candidates with the exact subblock-MC the decoder runs;
    PROF is omitted here (small refinement, applied at reconstruction).
    Returns [N, size, size] int32."""
    n = len(xs)
    mv = affine_mv_grid_batch(size, cpmvs, n_params)      # [N, nb, nb, 2]
    nb = size // SB
    mvx = mv[..., 0].reshape(-1)
    mvy = mv[..., 1].reshape(-1)
    ox = np.repeat(xs, nb * nb) + np.tile(np.tile(np.arange(nb) * SB, nb), n)
    oy = np.repeat(ys, nb * nb) + np.tile(np.repeat(np.arange(nb) * SB, nb),
                                          n)
    ix, fx = mvx >> 2, mvx & 3
    iy, fy = mvy >> 2, mvy & 3
    win = _gather_batched(plane, ox + ix, oy + iy, SB, 8)
    acc = _filter_batched(win, LUMA_FILTERS[fx], LUMA_FILTERS[fy], SB)
    pred = np.clip((acc + 2048) >> 12, 0, (1 << bit_depth) - 1)
    return (pred.reshape(n, nb, nb, SB, SB).transpose(0, 1, 3, 2, 4)
            .reshape(n, size, size).astype(np.int32))

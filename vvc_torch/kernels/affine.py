"""Affine motion: subblock-MV derivation, prediction, PROF.

Copy of the numpy half of vvc/kernels/affine.py (:46-251), which the
motion field, deblocking's boundary strengths and the batched MC import
even with affine off, and the port of its batched Gauss-Newton affine ME
(`affine_me_batch`, vvc's `_affine_me_jit`): CUDA kernel `affine_gn`
(vvc_torch/csrc/affine.cu) on a CUDA tensor, `affine_me_plain` on a CPU
tensor or inside `ops.plain()`.

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

import ctypes

import numpy as np
import torch

from vvc_torch import ops

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


# ---------------------------------------------------------------------------
# Batched Gauss-Newton affine ME (encoder only)
# ---------------------------------------------------------------------------
#
# vvc/kernels/affine.py:253 `affine_me_batch` (`_affine_me_jit`, :295):
# `iters` Gauss-Newton steps on a 4-parameter (tx, ty, a, b) or
# 6-parameter (tx, ty, a, b, c, d) model, every block in lockstep.  Each
# step warps the reference bilinearly (positions clipped to w − 1.001),
# takes the gradients with a wrap at the block edge (jnp.roll), builds the
# basis, A = BᵀB + 0.01·I and rhs = Bᵀe, and solves with `_solve_small`'s
# unpivoted Gauss-Jordan in its row order.  Every operation is float32
# with one rounding, in vvc's written order, with no contraction.  vvc's
# S²-term dots (the einsums) run as XLA-CPU dot kernels whose order the
# port does not reproduce; the port fixes its own: lane t of 256 sums the
# products t, t + 256, ... from 0, then the lanes meet in a halving tree.
# The kernel and this twin share that order, so they agree bit for bit;
# against vvc the corner MVs agree up to the rounding of 4·cp where it lies
# within float32 noise of a half-integer (tests/test_torch_r4me.py).

AFF_GN_LANES = 256
AFF_GN_CLIP = 1 << 17


def _lane_sum(p: torch.Tensor) -> torch.Tensor:
    """[..., P] float32 (P a power of 2) → [...]: lane t of min(256, P)
    sums p[t], p[t + lanes], ... left to right from 0, then the lanes are
    added in a halving tree (lane t += lane t + half)."""
    n = p.shape[-1]
    lanes = min(AFF_GN_LANES, n)
    acc = torch.zeros(p.shape[:-1] + (lanes,), dtype=torch.float32,
                      device=p.device)
    for k in range(0, n, lanes):
        acc = acc + p[..., k:k + lanes]
    while acc.shape[-1] > 1:
        half = acc.shape[-1] // 2
        acc = acc[..., :half] + acc[..., half:]
    return acc[..., 0]


def _gn_field(th: torch.Tensor, gx: torch.Tensor, gy: torch.Tensor,
              n_params: int):
    """The model's motion (vx, vy) at positions gx (x), gy (y), in vvc's
    order: vx = (t0 + t2·x) − t3·y, vy = (t1 + t3·x) + t2·y (4 parameters)
    or vx = (t0 + t2·x) + t4·y, vy = (t1 + t3·x) + t5·y (6)."""
    t = [th[:, k, None, None] for k in range(th.shape[1])]
    if n_params == 4:
        return (t[0] + t[2] * gx) - t[3] * gy, (t[1] + t[3] * gx) + t[2] * gy
    return (t[0] + t[2] * gx) + t[4] * gy, (t[1] + t[3] * gx) + t[5] * gy


def _solve_small_t(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """vvc's `_solve_small`: Gauss-Jordan on [N, p, p+1] = [A | b] without
    pivoting, row k normalised by its diagonal, then every other row i
    takes M[i] − M[i, k]·M[k]."""
    m = torch.cat([a, b[..., None]], dim=-1)
    p = a.shape[1]
    for k in range(p):
        m[:, k] = m[:, k] / m[:, k, k:k + 1]
        upd = m - m[:, :, k:k + 1] * m[:, k:k + 1, :]
        upd[:, k] = m[:, k]
        m = upd
    return m[:, :, p]


def affine_me_corners(blocks: torch.Tensor, ref: torch.Tensor, xs, ys,
                      mv0x, mv0y, size: int, n_params: int = 4,
                      iters: int = 4) -> torch.Tensor:
    """The Gauss-Newton search of `_affine_me_jit` up to its last rounding:
    blocks [N, S, S] and ref [H, W] float32 samples, origins xs, ys and
    quarter-pel seeds (mv0x, mv0y) [N] → 4·cp [N, 3, 2] float32, the corner
    MVs (TL, TR, BL) in quarter samples."""
    dev = ref.device
    n, s = blocks.shape[0], size
    h, w = ref.shape
    npar = 4 if n_params == 4 else 6
    blocks = blocks.to(torch.float32)
    ref = ref.to(torch.float32)
    theta = torch.zeros((n, npar), dtype=torch.float32, device=dev)
    theta[:, 0] = mv0x.to(torch.float32) / 4.0
    theta[:, 1] = mv0y.to(torch.float32) / 4.0
    gxp = torch.arange(s, dtype=torch.float32, device=dev)[None, None, :]
    gyp = torch.arange(s, dtype=torch.float32, device=dev)[None, :, None]
    xf = xs.to(torch.float32)[:, None, None]
    yf = ys.to(torch.float32)[:, None, None]
    hx, hy = float(np.float32(w - 1.001)), float(np.float32(h - 1.001))
    for _ in range(iters):
        vx, vy = _gn_field(theta, gxp, gyp, n_params)
        px = ((xf + gxp) + vx).clamp(0.0, hx)
        py = ((yf + gyp) + vy).clamp(0.0, hy)
        x0, y0 = torch.floor(px), torch.floor(py)
        ax, ay = px - x0, py - y0
        x0i, y0i = x0.long(), y0.long()
        x1i, y1i = (x0i + 1).clamp(max=w - 1), (y0i + 1).clamp(max=h - 1)
        p00, p01 = ref[y0i, x0i], ref[y0i, x1i]
        p10, p11 = ref[y1i, x0i], ref[y1i, x1i]
        pred = ((1 - ay) * ((1 - ax) * p00 + ax * p01)
                + ay * ((1 - ax) * p10 + ax * p11))
        err = blocks - pred
        gx = (pred.roll(-1, 2) - pred.roll(1, 2)) / 2.0
        gy = (pred.roll(-1, 1) - pred.roll(1, 1)) / 2.0
        if n_params == 4:
            basis = [gx, gy, gx * gxp + gy * gyp, -gx * gyp + gy * gxp]
        else:
            basis = [gx, gy, gx * gxp, gy * gxp, gx * gyp, gy * gyp]
        bf = [b.reshape(n, -1) for b in basis]
        a = torch.empty((n, npar, npar), dtype=torch.float32, device=dev)
        for i in range(npar):
            for j in range(i, npar):
                v = _lane_sum(bf[i] * bf[j])
                a[:, i, j] = v + np.float32(1e-2) if i == j else v
                a[:, j, i] = a[:, i, j]
        rhs = torch.stack([_lane_sum(b * err.reshape(n, -1)) for b in bf],
                          dim=1)
        theta = theta + _solve_small_t(a, rhs)
    corners = ((0.0, 0.0), (float(s), 0.0), (0.0, float(s)))
    cp = torch.stack([torch.stack([c[:, 0, 0] for c in _gn_field(
        theta, torch.tensor(px_, device=dev), torch.tensor(py_, device=dev),
        n_params)], dim=-1) for px_, py_ in corners], dim=1)
    return cp * 4.0


def affine_me_plain(blocks: torch.Tensor, ref: torch.Tensor, xs, ys, mv0x,
                    mv0y, size: int, n_params: int = 4,
                    iters: int = 4) -> torch.Tensor:
    """Plain twin of `_affine_me_jit` → cpmv [N, 3, 2] int32 quarter-pel:
    `affine_me_corners` rounded half to even (jnp.round) and clipped to
    ±2^17."""
    cp4 = affine_me_corners(blocks, ref, xs, ys, mv0x, mv0y, size, n_params,
                            iters)
    return torch.round(cp4).clamp(-AFF_GN_CLIP, AFF_GN_CLIP - 1).to(
        torch.int32)


def _affine_gn_cuda(blocks, ref, xs, ys, mv0x, mv0y, size: int,
                    n_params: int, iters: int) -> torch.Tensor:
    ops.check_cuda_i32("affine_gn", xs, ys, mv0x, mv0y)
    n = blocks.shape[0]
    if tuple(blocks.shape[1:]) != (size, size) or size not in (4, 8, 16, 32,
                                                               64):
        raise ValueError(f"affine_gn: blocks {tuple(blocks.shape)}")
    for t in (blocks, ref):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise TypeError("affine_gn: blocks and ref must be contiguous "
                            "float32")
    out = torch.empty((n, 3, 2), dtype=torch.int32, device=blocks.device)
    if n == 0:
        return out
    h, w = ref.shape
    fn = ops.lib("affine_gn").affine_gn_launch
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                   + [ctypes.c_float] * 2 + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    err = fn(blocks.data_ptr(), ref.data_ptr(), xs.data_ptr(), ys.data_ptr(),
             mv0x.data_ptr(), mv0y.data_ptr(), n, size, h, w,
             4 if n_params == 4 else 6, iters,
             float(np.float32(w - 1.001)), float(np.float32(h - 1.001)),
             out.data_ptr(), ops.stream_ptr(blocks))
    ops.launched("affine_gn", err)
    return out


def affine_me_batch(blocks, ref_plane, xs, ys, mv0x, mv0y, size: int,
                    bit_depth: int, n_params: int = 4,
                    iters: int = 4) -> torch.Tensor:
    """vvc/kernels/affine.py:253 `affine_me_batch`: Gauss-Newton CPMV search
    for N same-size square blocks → cpmv [N, 3, 2] int32 quarter-pel (TL,
    TR, BL; BL meaningful with 6 parameters).  `bit_depth` is unused, as in
    vvc.  CUDA tensors → vvc_torch/csrc/affine.cu `affine_gn`; CPU tensors
    or `ops.plain()` → affine_me_plain."""
    if ops.use_kernel(ref_plane):
        return _affine_gn_cuda(
            blocks.to(torch.float32).contiguous(),
            ref_plane.to(torch.float32).contiguous(),
            *(t.to(torch.int32).contiguous() for t in (xs, ys, mv0x, mv0y)),
            size, n_params, iters)
    return affine_me_plain(blocks, ref_plane, xs, ys, mv0x, mv0y, size,
                           n_params, iters)

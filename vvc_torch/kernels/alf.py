"""Adaptive Loop Filter — symmetric diamond Wiener filter application.

TPU-native analog of the reference's ALF
(`VTM/source/Lib/CommonLib/AdaptiveLoopFilter.cpp` →
ALFProcess / filterBlk (7×7 diamond luma, 5×5 chroma); OpenVVC
libovvc/rcn_alf.c).  SURVEY.md §2.2: "filter = depthwise conv"; here the
difference-form filter

    out = curr + ( Σ_i c_i · (n_a(i) + n_b(i) − 2·curr) + 64 ) >> 7

is a stack of shifted adds — pure VPU work, vectorized whole-plane.
(n_a, n_b) are the point-symmetric tap pairs of the diamond; c_i are
7-bit-scaled integers solved by least squares on (orig − rec)
(vvc_torch.enc.alf_enc).

Classified ALF (reference: AdaptiveLoopFilter::deriveClassification +
filterBlk): per-4×4 Laplacian gradient classification into 25 classes
(5 direction × 5 activity) with a per-block geometric transpose (4
transforms acting as static permutations of the symmetric tap pairs),
per-class filters with class→filter merging, and nonlinear clipping of
the neighbour differences (uniform per-filter clip level — the spec's
per-tap clip indices are simplified [verify]).  Everything is
whole-plane vectorized: Laplacians are shifted adds, the 8×8 window sums
ride an integral image, per-pixel filter/transpose selection is a gather.

Remaining simplifications [verify]: coefficients ride the slice header
(APS NAL transport later), dense Laplacian positions (the spec
subsamples 2×), edge-replicate padding.

Port of vvc/kernels/alf.py.  The classification and the classified delta
run in the native recon core (`alf_classify_c`, `alf_delta_classified_c`
of vvc_torch/packer/recon_core.cpp), which must build: there is no numpy
fallback (the numpy versions stay as the oracles).  The encoder's
statistics (`alf_stats_dev`, the port of vvc/kernels/alf.py:330) run on
the device: on a CUDA tensor they launch the kernel of
vvc_torch/csrc/alf_stats.cu, on a CPU tensor or inside `ops.plain()` they
run their plain PyTorch twin.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from vvc_torch import ops

ALF_SHIFT = 7  # coefficient scale 1<<7


@lru_cache(maxsize=None)
def diamond_pairs(radius: int):
    """Point-symmetric tap pairs of a (2r+1) diamond, excluding center.

    Returns tuple of ((dy, dx), (-dy, -dx)) with one canonical member per
    pair.  radius 3 → 12 pairs (7×7 luma), radius 2 → 6 pairs (5×5 chroma).
    """
    pairs = []
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            if abs(dy) + abs(dx) == 0 or abs(dy) + abs(dx) > radius:
                continue
            if (dy, dx) > (-dy, -dx):
                continue
            pairs.append(((dy, dx), (-dy, -dx)))
    return tuple(pairs)


def _shift(plane: np.ndarray, dy: int, dx: int) -> np.ndarray:
    """Edge-replicate shifted view."""
    h, w = plane.shape
    ys = np.clip(np.arange(h) + dy, 0, h - 1)
    xs = np.clip(np.arange(w) + dx, 0, w - 1)
    return plane[ys[:, None], xs[None, :]]


def pair_features(rec: np.ndarray, radius: int) -> np.ndarray:
    """[n_pairs, H, W] difference features (n_a + n_b − 2·curr), int32.
    One edge pad + pure slices (no index gathers)."""
    r32 = rec.astype(np.int32)
    h, w = rec.shape
    p = np.pad(r32, radius, mode="edge")
    feats = np.empty((len(diamond_pairs(radius)), h, w), dtype=np.int32)
    for i, ((ady, adx), (bdy, bdx)) in enumerate(diamond_pairs(radius)):
        na = p[radius + ady:radius + ady + h, radius + adx:radius + adx + w]
        nb = p[radius + bdy:radius + bdy + h, radius + bdx:radius + bdx + w]
        np.subtract(na + nb, 2 * r32, out=feats[i])
    return feats


def alf_delta(rec: np.ndarray, coeffs, radius: int,
              feats: np.ndarray | None = None) -> np.ndarray:
    """Integer filter delta for the whole plane (before CTU gating)."""
    if feats is None:
        feats = pair_features(rec, radius)
    c = np.asarray(coeffs, dtype=np.int64)
    acc = np.tensordot(c, feats.astype(np.int64), axes=1)
    acc += 1 << (ALF_SHIFT - 1)
    return (acc >> ALF_SHIFT).astype(np.int32)


# ---------------------------------------------------------------------------
# 25-class gradient classification (reference: deriveClassificationBlk)
# ---------------------------------------------------------------------------

# activity → Â table (reference: AdaptiveLoopFilter th[] shape)
_ACT_TAB = np.array([0, 1, 2, 2, 2, 2, 2, 3, 3, 3, 3, 3, 3, 3, 3, 4],
                    dtype=np.int32)
# (mainDir*2 + (secondaryDir>>1)) → transposeIdx (reference transposeTable)
_TRANSPOSE_TAB = np.array([0, 1, 0, 2, 2, 3, 1, 3], dtype=np.int32)


def _box4(lap: np.ndarray, h4: int, w4: int) -> np.ndarray:
    """8×8 window sums at 4×4 stride (window centered on each 4×4 block,
    ±2 sample margin) via integral image.  lap covers samples −1..H
    (one-sample halo); one more edge-replicated ring extends it to ±2."""
    p = np.pad(lap, 1, mode="edge")
    ii = np.pad(np.cumsum(np.cumsum(p, 0), 1), ((1, 0), (1, 0)))
    ys = np.arange(h4) * 4
    xs = np.arange(w4) * 4
    y1 = ys + 8
    x1 = xs + 8
    return (ii[y1[:, None], x1[None, :]] - ii[y1[:, None], xs[None, :]]
            - ii[ys[:, None], x1[None, :]] + ii[ys[:, None], xs[None, :]])


def _native_lib():
    """The native recon core; raises if it cannot be built (vvc falls back
    to numpy here, the port does not)."""
    from vvc_torch.packer import recon_lib
    return recon_lib()


def alf_classify(rec: np.ndarray, bit_depth: int = 8):
    """Native C++ classification (bit-exact mirror of alf_classify_np)."""
    lib = _native_lib()
    h, w = rec.shape
    h4, w4 = h // 4, w // 4
    cls = np.empty((h4, w4), np.int32)
    tr = np.empty((h4, w4), np.int32)
    r = np.ascontiguousarray(rec, dtype=np.int32)
    lib.alf_classify_c(r.ctypes.data_as(ctypes.c_void_p), h, w,
                       bit_depth, cls.ctypes.data_as(ctypes.c_void_p),
                       tr.ctypes.data_as(ctypes.c_void_p))
    return cls, tr


def alf_classify_np(rec: np.ndarray, bit_depth: int = 8):
    """Per-4×4 (class_idx [H/4,W/4] 0..24, transpose_idx [H/4,W/4] 0..3).

    Laplacian gradients in 4 directions over an 8×8 window per block;
    direction from the HV/diagonal dominance ratios (thresholds 2 and
    4.5, reference shape), activity from (sumV+sumH) quantized to 5
    levels.  [verify] exact spec subsampling/shift once the mount has
    the reference."""
    r = rec.astype(np.int32)
    h, w = r.shape
    h4, w4 = h // 4, w // 4
    p = np.pad(r, 2, mode="edge")
    c = p[1:-1, 1:-1]
    lv = np.abs(2 * c - p[:-2, 1:-1] - p[2:, 1:-1])
    lh = np.abs(2 * c - p[1:-1, :-2] - p[1:-1, 2:])
    ld0 = np.abs(2 * c - p[:-2, :-2] - p[2:, 2:])
    ld1 = np.abs(2 * c - p[:-2, 2:] - p[2:, :-2])
    sv = _box4(lv, h4, w4)
    sh = _box4(lh, h4, w4)
    s0 = _box4(ld0, h4, w4)
    s1 = _box4(ld1, h4, w4)
    hv1 = np.maximum(sv, sh)
    hv0 = np.minimum(sv, sh)
    dir_hv = np.where(sv > sh, 1, 3)
    d1 = np.maximum(s0, s1)
    d0 = np.minimum(s0, s1)
    dir_d = np.where(s0 > s1, 0, 2)
    hv_stronger = hv1 * d0 > d1 * hv0
    hvd1 = np.where(hv_stronger, hv1, d1)
    hvd0 = np.where(hv_stronger, hv0, d0)
    main_dir = np.where(hv_stronger, dir_hv, dir_d)
    sec_dir = np.where(hv_stronger, dir_d, dir_hv)
    strength = np.where(2 * hvd1 > 9 * hvd0, 2,
                        np.where(hvd1 > 2 * hvd0, 1, 0))
    act = np.clip(((sv + sh) * 64) >> (4 + bit_depth), 0, 15)
    cls = _ACT_TAB[act]
    cls = cls + np.where(strength > 0,
                         (((main_dir & 1) << 1) + strength) * 5, 0)
    tr = _TRANSPOSE_TAB[main_dir * 2 + (sec_dir >> 1)]
    return cls.astype(np.int32), tr.astype(np.int32)


@lru_cache(maxsize=None)
def pair_transpose_perms(radius: int) -> np.ndarray:
    """[4, n_pairs] permutation: perm[t, i] = canonical pair index of the
    t-transformed offset of pair i (transforms: none, diagonal flip,
    vertical flip, rotation — the reference's geometric transforms acting
    on the point-symmetric pair set)."""
    pairs = diamond_pairs(radius)
    rep = {p[0]: i for i, p in enumerate(pairs)}

    def canon(dy, dx):
        return rep[(dy, dx)] if (dy, dx) in rep else rep[(-dy, -dx)]

    tf = (lambda dy, dx: (dy, dx), lambda dy, dx: (dx, dy),
          lambda dy, dx: (-dy, dx), lambda dy, dx: (dx, -dy))
    out = np.empty((4, len(pairs)), dtype=np.int32)
    for t, f in enumerate(tf):
        for i, ((dy, dx), _) in enumerate(pairs):
            out[t, i] = canon(*f(dy, dx))
    return out


def alf_delta_classified(rec, coeffs, clips, fmap, cls4, tr4,
                         radius: int = 3) -> np.ndarray:
    """Native C++ classified delta (radius 3), numpy for other radii."""
    if radius == 3:
        lib = _native_lib()
        h, w = rec.shape
        pairs = np.asarray([(a[0], a[1], b[0], b[1])
                            for a, b in diamond_pairs(radius)], np.int32)
        perms = np.ascontiguousarray(pair_transpose_perms(radius), np.int32)
        r = np.ascontiguousarray(rec, np.int32)
        cf = np.ascontiguousarray(coeffs, np.int32)
        cl = np.ascontiguousarray(clips, np.int32)
        fm = np.ascontiguousarray(fmap, np.int32)
        c4 = np.ascontiguousarray(cls4, np.int32)
        t4 = np.ascontiguousarray(tr4, np.int32)
        out = np.empty((h, w), np.int32)
        p = ctypes.c_void_p
        lib.alf_delta_classified_c(
            r.ctypes.data_as(p), h, w, cf.ctypes.data_as(p),
            cl.ctypes.data_as(p), cf.shape[0], fm.ctypes.data_as(p),
            c4.ctypes.data_as(p), t4.ctypes.data_as(p),
            pairs.ctypes.data_as(p), perms.ctypes.data_as(p),
            pairs.shape[0], out.ctypes.data_as(p))
        return out
    return alf_delta_classified_np(rec, coeffs, clips, fmap, cls4, tr4,
                                   radius)


def alf_delta_classified_np(rec: np.ndarray, coeffs: np.ndarray,
                            clips: np.ndarray, fmap: np.ndarray,
                            cls4: np.ndarray, tr4: np.ndarray,
                            radius: int = 3) -> np.ndarray:
    """Classified, clipped filter delta for the whole plane (numpy).

    coeffs [nf, n_pairs] int32 (1<<7 scale); clips [nf] int32 clip bound
    per filter (0 = no clipping); fmap [25] class→filter; cls4/tr4 from
    alf_classify.  Per-pixel coefficient/clip selection is a gather;
    features are clip(n_a−curr)+clip(n_b−curr)."""
    h, w = rec.shape
    r32 = rec.astype(np.int32)
    p = np.pad(r32, radius, mode="edge")
    fidx = fmap[cls4]                                   # [h4, w4]
    fpx = np.repeat(np.repeat(fidx, 4, 0), 4, 1)[:h, :w]
    tpx = np.repeat(np.repeat(tr4, 4, 0), 4, 1)[:h, :w]
    perms = pair_transpose_perms(radius)                # [4, np]
    # clip 0 = off → sentinel bound that never clips (uniform fast path)
    big = np.int32(1 << 12)   # > any |sample diff| at <=10-bit; keeps
                              # the int32 accumulator far from overflow
    bpx = np.where(clips[fpx] > 0, clips[fpx], big)     # [H, W]
    # int32 accumulator: |c| <= 127, |clipped diff sum| <= 2^(bd+1),
    # 12 taps -> < 2^23 at 10-bit — no overflow
    acc = np.full((h, w), 1 << (ALF_SHIFT - 1), dtype=np.int32)
    pairs = diamond_pairs(radius)
    # per-pixel coefficient for tap i = coeffs[fpx, perms[tpx, i]]
    for i, ((ady, adx), (bdy, bdx)) in enumerate(pairs):
        na = p[radius + ady:radius + ady + h, radius + adx:radius + adx + w]
        nb = p[radius + bdy:radius + bdy + h, radius + bdx:radius + bdx + w]
        da = np.clip(na - r32, -bpx, bpx)
        db = np.clip(nb - r32, -bpx, bpx)
        ci = coeffs[fpx, perms[tpx, i]]
        acc += ci * (da + db)
    return acc >> ALF_SHIFT


def apply_delta_gated(plane: np.ndarray, delta: np.ndarray, bit_depth: int,
                      ctu_flags=None, ctu_size: int = 0):
    """Apply a precomputed filter delta in place with per-CTU gating
    (the encoder reuses the delta its decision pass already computed)."""
    maxv = (1 << bit_depth) - 1
    if ctu_flags is None:
        plane[:] = np.clip(plane + delta, 0, maxv)
        return
    h, w = plane.shape
    for (x0, y0), on in ctu_flags.items():
        if not on or x0 >= w or y0 >= h:
            continue
        sl = np.s_[y0:min(y0 + ctu_size, h), x0:min(x0 + ctu_size, w)]
        plane[sl] = np.clip(plane[sl] + delta[sl], 0, maxv)


def apply_alf_classified(plane: np.ndarray, coeffs, clips, fmap, bit_depth,
                         ctu_flags=None, ctu_size: int = 0, cls4=None,
                         tr4=None):
    """Apply classified luma ALF in place with per-CTU gating."""
    if cls4 is None:
        cls4, tr4 = alf_classify(plane, bit_depth)
    delta = alf_delta_classified(plane, np.asarray(coeffs, np.int32),
                                 np.asarray(clips, np.int32),
                                 np.asarray(fmap, np.int32), cls4, tr4)
    maxv = (1 << bit_depth) - 1
    if ctu_flags is None:
        plane[:] = np.clip(plane + delta, 0, maxv)
        return
    h, w = plane.shape
    for (x0, y0), on in ctu_flags.items():
        if not on or x0 >= w or y0 >= h:
            continue
        sl = np.s_[y0:min(y0 + ctu_size, h), x0:min(x0 + ctu_size, w)]
        plane[sl] = np.clip(plane[sl] + delta[sl], 0, maxv)


def apply_alf_plane(plane: np.ndarray, coeffs, radius: int, bit_depth: int,
                    ctu_flags=None, ctu_size: int = 0, delta=None):
    """Apply ALF in place; ctu_flags {(x0,y0): bool} gates per-CTU regions
    (None → whole plane)."""
    if delta is None:
        delta = alf_delta(plane, coeffs, radius)
    maxv = (1 << bit_depth) - 1
    if ctu_flags is None:
        plane[:] = np.clip(plane + delta, 0, maxv)
        return
    h, w = plane.shape
    for (x0, y0), on in ctu_flags.items():
        if not on or x0 >= w or y0 >= h:
            continue
        sl = np.s_[y0:min(y0 + ctu_size, h), x0:min(x0 + ctu_size, w)]
        plane[sl] = np.clip(plane[sl] + delta[sl], 0, maxv)


# ------------------------------------------------------------------
# device-side encoder statistics
# ------------------------------------------------------------------

N_PAIRS = 12        # diamond_pairs(3)
N_GROUPS = 100      # class · 4 + transpose


def _alf_grid(o: torch.Tensor, r: torch.Tensor, cls4: torch.Tensor,
              tr4: torch.Tensor):
    """The 2×2-subsampled grid of vvc's alf_stats_dev: features F [12, P]
    (n_a + n_b − 2r, edge-padded by 3), target t [P] (o − r), group key
    [P] (class · 4 + transpose) and class [P], all int64."""
    h, w = o.shape
    dev = o.device
    ys = torch.arange(0, h, 2, device=dev)
    xs = torch.arange(0, w, 2, device=dev)
    r64 = r.to(torch.int64)
    c = r64[ys][:, xs]
    feats = []
    for (ady, adx), (bdy, bdx) in diamond_pairs(3):
        na = r64[(ys + ady).clamp(0, h - 1)][:, (xs + adx).clamp(0, w - 1)]
        nb = r64[(ys + bdy).clamp(0, h - 1)][:, (xs + bdx).clamp(0, w - 1)]
        feats.append((na + nb - 2 * c).reshape(-1))
    t = (o.to(torch.int64)[ys][:, xs] - c).reshape(-1)
    cls = cls4.to(torch.int64)[ys // 4][:, xs // 4].reshape(-1)
    key = cls * 4 + tr4.to(torch.int64)[ys // 4][:, xs // 4].reshape(-1)
    return torch.stack(feats), t, key, cls


# vvc's B100 dot (F·m)ᵀt lowers, from this many grid points on, to
# XLA-CPU's tiled row-major GEMV (below it is fused into a loop); the
# GEMV's float32 order is reproduced (`_b100_gemv`)
B100_GEMV_MIN_POINTS = 4096


def _lane_tree(a: torch.Tensor, row_tail: bool) -> torch.Tensor:
    """The GEMV's horizontal add of 8 lane sums (last axis): rows 0..7 of
    a tile ((a0+a1)+(a2+a3))+((a4+a5)+(a6+a7)); rows 8..11 (the tail
    tile) ((a0+a4)+(a2+a6))+((a1+a5)+(a3+a7))."""
    if row_tail:
        return (((a[..., 0] + a[..., 4]) + (a[..., 2] + a[..., 6]))
                + ((a[..., 1] + a[..., 5]) + (a[..., 3] + a[..., 7])))
    return (((a[..., 0] + a[..., 1]) + (a[..., 2] + a[..., 3]))
            + ((a[..., 4] + a[..., 5]) + (a[..., 6] + a[..., 7])))


def _b100_gemv(F: torch.Tensor, t: torch.Tensor, key: torch.Tensor,
               exact: torch.Tensor) -> torch.Tensor:
    """B100 [100, 12] float32 bit-equal to vvc's on XLA-CPU, from the
    exact int64 sums `exact`.  vvc's `Fw @ t` (Fw = F masked to the group)
    is the tiled GEMV `row_major_gemv_F32_8_8_12_P` (read from its
    optimised IR, jax 0.9.0, at 416×240 and 1080p): lane j of row k sums
    the products of the points p ≡ j (mod 8) in increasing p from 0 (the
    masked zeros change nothing; every product is exact), and the lanes
    meet in `_lane_tree` (rows 0..7 and 8..11 differ).  P is a multiple of
    16 (picture sides are multiples of 8).  Where Σ|F·t| of an entry stays
    below 2^24 every partial sum is exact in any order, so the exact sum
    is the answer; the others are summed in that order."""
    assert t.numel() % 8 == 0, t.numel()
    prod = F * t[None, :]                                   # [12, P] int64
    absb = torch.zeros_like(exact)
    absb.index_add_(0, key, prod.abs().T)
    out = exact.to(torch.float32)
    need = absb >= (1 << 24)
    pos = torch.arange(t.numel(), device=t.device)
    pf = prod.to(torch.float32)                   # exact: |F·t| < 2^24
    for g in torch.nonzero(need.any(dim=1)).reshape(-1).tolist():
        sel = pos[key == g]
        lanes = [pf[:, sel[sel % 8 == j]] for j in range(8)]
        n = max(x.shape[1] for x in lanes)
        v = torch.zeros((12, 8, n), dtype=torch.float32, device=t.device)
        for j, x in enumerate(lanes):
            v[:, j, :x.shape[1]] = x
        acc = torch.zeros((12, 8), dtype=torch.float32, device=t.device)
        for i in range(n):
            acc = acc + v[:, :, i]
        b = torch.cat([_lane_tree(acc[:8], False), _lane_tree(acc[8:], True)])
        out[g] = torch.where(need[g], b, out[g])
    return out


def alf_stats_plain(o: torch.Tensor, r: torch.Tensor, cls4: torch.Tensor,
                    tr4: torch.Tensor, chunk: int = 1 << 16):
    """Plain twin of the `alf_stats` kernel: vvc/kernels/alf.py:330
    alf_stats_dev's sums taken exactly (int64 products summed in float64,
    exact: every partial sum is an integer below 2^53) and rounded once
    to float32, except B100 from B100_GEMV_MIN_POINTS grid points on,
    which takes vvc's float32 GEMV order (`_b100_gemv`).  vvc's A100 is an
    Eigen contraction whose float32 order is not reproduced, so A100 (and
    B100 on smaller grids) differs from vvc's in the last bits of some
    entries (ROADMAP §3).
    → (A100 [100,12,12], B100 [100,12], sse0 [25], npx [25]) float32."""
    F, t, key, cls = _alf_grid(o, r, cls4, tr4)
    dev = o.device
    acc = torch.zeros((N_GROUPS, N_PAIRS * N_PAIRS + N_PAIRS),
                      dtype=torch.float64, device=dev)
    for s in range(0, t.numel(), chunk):
        f = F[:, s:s + chunk].T                              # [p, 12]
        prod = torch.cat([(f[:, :, None] * f[:, None, :]).reshape(-1, 144),
                          f * t[s:s + chunk, None]], dim=1)
        acc.index_add_(0, key[s:s + chunk], prod.to(torch.float64))
    per = torch.zeros((25, 2), dtype=torch.float64, device=dev)
    per.index_add_(0, cls, torch.stack([t * t, torch.ones_like(t)],
                                       dim=1).to(torch.float64))
    b100 = acc[:, 144:].to(torch.float32)
    if t.numel() >= B100_GEMV_MIN_POINTS:
        b100 = _b100_gemv(F, t, key, acc[:, 144:].to(torch.int64))
    acc = acc.to(torch.float32)
    per = per.to(torch.float32)
    return (acc[:, :144].reshape(N_GROUPS, N_PAIRS, N_PAIRS).contiguous(),
            b100.contiguous(), per[:, 0].contiguous(),
            per[:, 1].contiguous())


def _stats_grid(h: int, w: int, h4: int, w4: int):
    """The `alf_stats` kernel's grid for [h, w] planes and [h4, w4]
    classification maps → (grid points P, whether B100 takes the GEMV
    order).  Raises on maps too small for the grid (each 4×4 cell covers
    2×2 grid points) and on a GEMV grid that is not a multiple of 8."""
    hs, ws = (h + 1) // 2, (w + 1) // 2
    if h4 < (hs + 1) // 2 or w4 < (ws + 1) // 2:
        raise ValueError(f"alf_stats: classification maps {h4}×{w4} do not "
                         f"cover the {hs}×{ws} grid")
    npts = hs * ws
    gemv = npts >= B100_GEMV_MIN_POINTS
    if gemv and npts % 8:
        raise ValueError("alf_stats: the GEMV order needs a multiple of 8 "
                         "grid points")
    return npts, gemv


@lru_cache(maxsize=None)
def _stats_launch():
    fn = ops.lib("alf_stats").alf_stats_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _alf_stats_cuda(o, r, cls4, tr4):
    ops.check_cuda_i32("alf_stats", o, r, cls4, tr4)
    if tr4.shape != cls4.shape or r.shape != o.shape:
        raise ValueError("alf_stats: o/r and cls4/tr4 must match in shape")
    h, w = o.shape
    npts, gemv = _stats_grid(h, w, *cls4.shape)
    # one scratch buffer (csrc/alf_stats.cu alf_stats_launch): the int64
    # sums (104 a key) and the walk's counters (one a key); for the GEMV
    # order's walk its lane sums (float32), each grid point's key byte and
    # its 12 products F·t (float32); each part a multiple of 16 bytes
    walk = npts if gemv else 0
    sizes = [N_GROUPS * 105 * 8, N_GROUPS * 8 * N_PAIRS * 4 if gemv else 0,
             -(-walk // 16) * 16, 48 * walk]
    acc, lanes, keys, ft = torch.empty(
        (sum(sizes),), dtype=torch.uint8, device=o.device).split(sizes)
    # the outputs, one float32 buffer: A100, B100, sse0, npx
    a, b, sse0, npx = torch.empty(
        (N_GROUPS * (N_PAIRS + 1) * N_PAIRS + 50,), dtype=torch.float32,
        device=o.device).split([N_GROUPS * N_PAIRS * N_PAIRS,
                                N_GROUPS * N_PAIRS, 25, 25])
    err = _stats_launch()(
        o.data_ptr(), r.data_ptr(), cls4.data_ptr(), tr4.data_ptr(), h, w,
        cls4.shape[1], acc.data_ptr(), keys.data_ptr(), ft.data_ptr(),
        lanes.data_ptr(), a.data_ptr(), b.data_ptr(), sse0.data_ptr(),
        npx.data_ptr(), int(gemv), ops.stream_ptr(o))
    ops.launched("alf_stats", err)
    return (a.view(N_GROUPS, N_PAIRS, N_PAIRS), b.view(N_GROUPS, N_PAIRS),
            sse0, npx)


def alf_stats_dev(o: torch.Tensor, r: torch.Tensor, cls4: torch.Tensor,
                  tr4: torch.Tensor):
    """o/r [H,W] int32, cls4/tr4 [ceil(H/4),ceil(W/4)] int32 →
    (A100 [100,12,12], B100 [100,12], sse0 [25], npx [25]) float32 on the
    planes' device: the raw per-(class·4 + transpose) normal equations on
    the 2×2-subsampled grid (the host applies the transpose permutations
    and the ×4 rescale).  CUDA tensor → csrc/alf_stats.cu `alf_stats`;
    CPU tensor or `ops.plain()` → the twin."""
    if ops.use_kernel(o):
        return _alf_stats_cuda(o, r, cls4, tr4)
    return alf_stats_plain(o, r, cls4, tr4)

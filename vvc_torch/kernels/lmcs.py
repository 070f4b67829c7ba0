"""LMCS — luma mapping with chroma scaling (mapping half).

Copy of vvc/kernels/lmcs.py (host numpy, unchanged): the decoder's inverse
mapping and chroma scaling, and the recon core's chroma scale factors.

TPU-native analog of the reference's Reshape
(`VTM/source/Lib/CommonLib/Reshape.cpp` → forward/inverse luma
mapping LUTs; EncoderLib/EncReshape.cpp → PWL codeword allocation).
SURVEY.md §2.2: "1-D LUT gather" — both directions are pure table lookups,
ideal VPU work.

The 16-piece piecewise-linear mapping is described by codeword counts
cw[0..15] (signalled in the slice header; APS later [verify]).  Both LUTs
are built integer-deterministically from cw by encoder and decoder:

    fwd(x) = mapped_start[i] + (cw[i]·(x − 2^(B-4)·i) + 2^(B-5)) >> (B-4-?)

using the exact construction below.  Encoding operates entirely in the
mapped domain (intra prediction, transforms, RDO); the inverse map is
applied to the reconstruction before the in-loop filters — the reference's
domain layout.  Chroma residual scaling lands later [verify].
"""
from __future__ import annotations

import numpy as np

N_PIECES = 16


def build_luts(codewords, bit_depth: int):
    """(fwd_lut, inv_lut) uint arrays of length 2^bit_depth.

    codewords: 16 ints; the mapped range is their cumulative sum (clipped
    to 2^bit_depth − 1).  Piecewise-linear with integer slope arithmetic
    (scale 1<<11), exactly reproducible on both sides.
    """
    maxv = (1 << bit_depth) - 1
    seg = 1 << (bit_depth - 4)            # input samples per piece
    cw = np.asarray(codewords, dtype=np.int64)
    starts = np.concatenate([[0], np.cumsum(cw)])[:N_PIECES]
    x = np.arange(1 << bit_depth, dtype=np.int64)
    piece = x >> (bit_depth - 4)
    off = x - (piece << (bit_depth - 4))
    slope = (cw[piece] << 11) // seg      # fixed-point slope per piece
    fwd = starts[piece] + ((slope * off + (1 << 10)) >> 11)
    fwd = np.clip(fwd, 0, maxv).astype(np.int32)
    # inverse: for each mapped value, the input value whose fwd is nearest
    # below — built by forward scanning (monotone non-decreasing fwd)
    inv = np.zeros(1 << bit_depth, dtype=np.int32)
    inv[fwd] = x.astype(np.int32)         # last writer wins on plateaus
    # fill gaps by forward propagation
    np.maximum.accumulate(inv, out=inv)
    return fwd, inv


def derive_codewords(y_plane: np.ndarray, bit_depth: int):
    """Histogram-based codeword allocation (encoder side, non-normative;
    reference: EncReshape::preAnalyzer*).  Pieces covering busy luma ranges
    get more codewords (finer quantization there)."""
    maxv = (1 << bit_depth) - 1
    hist, _ = np.histogram(y_plane, bins=N_PIECES, range=(0, maxv + 1))
    p = hist / max(1, hist.sum())
    # allocation ∝ p^(1/3), bounded to [seg/2, 2*seg], total ≈ 2^bd
    seg = 1 << (bit_depth - 4)
    w = np.cbrt(np.maximum(p, 1e-6))
    alloc = w / w.sum() * (1 << bit_depth)
    alloc = np.clip(alloc, seg // 2, 2 * seg)
    # renormalize to total 2^bd by iterative scaling
    for _ in range(8):
        alloc = alloc * ((1 << bit_depth) / alloc.sum())
        alloc = np.clip(alloc, seg // 2, 2 * seg)
    cw = np.round(alloc).astype(np.int64)
    cw[-1] += (1 << bit_depth) - cw.sum()  # exact total
    cw[-1] = max(1, cw[-1])
    return [int(v) for v in cw]


def map_plane(plane: np.ndarray, lut: np.ndarray) -> np.ndarray:
    return lut[np.clip(plane, 0, len(lut) - 1)]


CSCALE_SHIFT = 11


def chroma_scale_factors(codewords, bit_depth: int):
    """Per-piece (fwd_scale, inv_scale) fixed-point (1<<11) chroma residual
    scales (reference: Reshape::calcChromaScale / spec 8.7.5.3 cScaleInv).
    fwd multiplies the residual on the encoder side, inv on the decoder
    side; pieces with zero codewords scale by 1."""
    seg = 1 << (bit_depth - 4)
    cw = np.asarray(codewords, dtype=np.int64)
    one = 1 << CSCALE_SHIFT
    fwd = np.where(cw > 0, (cw << CSCALE_SHIFT) // seg, one)
    inv = np.where(cw > 0,
                   ((seg << CSCALE_SHIFT) + cw // 2) // np.maximum(cw, 1),
                   one)
    return fwd.astype(np.int64), inv.astype(np.int64)


def piece_of_mapped(avg_mapped: int, codewords, bit_depth: int) -> int:
    """Piece index of a mapped-domain luma average (searchsorted over the
    cumulative mapped starts)."""
    starts = np.concatenate([[0], np.cumsum(np.asarray(codewords,
                                                       np.int64))])
    i = int(np.searchsorted(starts, avg_mapped, side="right")) - 1
    return max(0, min(N_PIECES - 1, i))

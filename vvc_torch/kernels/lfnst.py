"""LFNST: low-frequency non-separable secondary transform.

TPU-native analog of the reference's LFNST
(`VTM/source/Lib/CommonLib/TrQuant.cpp` -> xFwdLfnst /
xInvLfnst; set selection g_lfnstLut shape).  Kernels are analytically
derived (vvc_torch/rom/lfnst_mats.py -- the reference's trained tables are not
copyable).  On TPU the whole thing is a tiny batched matmul, applied
between the primary DCT2 transform and quantization:

  forward (encoder): c = DCT2(resi); y = (B_g @ vec(c[0:8,0:8]) + 32)>>6
    -- the 16 secondary coefficients land in the top-left 4x4 (raster),
       everything else in the block is zeroed (the reference's zero-out).
  inverse (both sides): vec(c[0:8,0:8]) = (B_g^T @ y + 32) >> 6
    -- encoder reconstruction and decoder share this integer inverse, so
       bit-exactness holds by construction even though B is low-rank.

Set selection mirrors the reference's mode classing: planar/DC -> set 0,
near-horizontal (2..12) -> 1, diagonal (13..23) -> 2, near-vertical
(24..34) -> 3; modes > 34 (DIA) reuse the mirrored set on the TRANSPOSED
coefficient block.  MIP modes map to set 0.  Luma only (single tree).
LFNST pairs only with the primary DCT2 (mts == 0).

This copy holds the numpy parts (the RDO asks `lfnst_allowed`; the native
reconstruction core loads the kernels).  The batched device versions
(vvc/kernels/lfnst.py:94,109) arrive with slice 2b.
"""
from __future__ import annotations

import numpy as np

from vvc_torch.rom.lfnst_mats import lfnst_kernels

LFNST_SHIFT = 6
LFNST_MIN_SIZE = 8


def lfnst_allowed(size: int) -> bool:
    return size >= LFNST_MIN_SIZE


def lfnst_set(mode: int) -> tuple[int, bool]:
    """Intra luma mode -> (transform set, transpose flag)."""
    if mode >= 67:                       # MIP
        return 0, False
    t = mode > 34
    m = 68 - mode if t else mode
    if m <= 1:
        g = 0
    elif m <= 12:
        g = 1
    elif m <= 23:
        g = 2
    else:
        g = 3
    return g, t


def fwd_lfnst_np(coeff: np.ndarray, mode: int, lfnst_idx: int) -> np.ndarray:
    """SxS primary coefficients -> SxS secondary-coded block (top-left 4x4
    carries the 16 secondary coefficients; the rest is zeroed out)."""
    g, t = lfnst_set(mode)
    b = lfnst_kernels()[g, lfnst_idx - 1].astype(np.int64)   # [16, 64]
    c8 = coeff[:8, :8]
    if t:
        c8 = c8.T
    y = (b @ c8.reshape(64).astype(np.int64) + 32) >> LFNST_SHIFT
    out = np.zeros_like(coeff)
    out[:4, :4] = np.clip(y, -32768, 32767).reshape(4, 4).astype(coeff.dtype)
    return out


def inv_lfnst_np(deq: np.ndarray, mode: int, lfnst_idx: int) -> np.ndarray:
    """SxS dequantized block (secondary coeffs in top-left 4x4) -> SxS
    primary coefficients (top-left 8x8 populated, rest zero)."""
    g, t = lfnst_set(mode)
    b = lfnst_kernels()[g, lfnst_idx - 1].astype(np.int64)
    y = deq[:4, :4].reshape(16).astype(np.int64)
    c8 = (b.T @ y + 32) >> LFNST_SHIFT
    c8 = np.clip(c8, -32768, 32767).reshape(8, 8)
    if t:
        c8 = c8.T
    out = np.zeros_like(deq)
    out[:8, :8] = c8.astype(deq.dtype)
    return out

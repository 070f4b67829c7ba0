"""Matrix intra prediction (MIP): boundary pool -> matmul -> upsample.

TPU-native analog of the reference's MIP
(`VTM/source/Lib/CommonLib/MatrixIntraPrediction.cpp` ->
prepareInputForPred / predBlock; weights MipData.h).  SURVEY.md §2.2 calls
this "literally matmul — MXU native": the whole mode family for every
block of a size evaluates as ONE [N, 8] x [K, 64, 8] einsum on the MXU.

Our design (weights: vvc_torch/rom/mip_mats.py, analytically derived — the
reference's trained tables are not copyable):

  1. reduce: top S and left S reference samples average-pool to 4 + 4
  2. center: subtract the integer mean m = (sum(b) + 4) >> 3
  3. matmul: red = clip(((W_k @ (b - m)) + 32) >> 6 + m)   (8x8 grid)
  4. upsample (S > 8): linear interpolation anchored on the ORIGINAL
     boundary — reduced sample (i, j) sits at (x, y) = ((j+1)u - 1,
     (i+1)u - 1) with u = S/8; row y=-1 anchors to the top boundary,
     column x=-1 to the left boundary (horizontal pass, then vertical).

Applies to square sizes 8..32 (QT round-1 geometry).  Mode index space:
luma_mode = 67 + k, k in [0, K_MIP_MODES).
"""
from __future__ import annotations

import numpy as np

from vvc_torch.rom.mip_mats import mip_weights, K_MIP_MODES

MIP_MODE_BASE = 67           # luma_mode >= MIP_MODE_BASE -> MIP mode
MIP_MIN_SIZE, MIP_MAX_SIZE = 8, 32


def mip_allowed(size: int) -> bool:
    return MIP_MIN_SIZE <= size <= MIP_MAX_SIZE


def _log2(v: int) -> int:
    return int(v).bit_length() - 1


# ---------------------------------------------------------------------------
# numpy oracle (single block) — used by the sequential recon path
# ---------------------------------------------------------------------------


def _reduce_boundary_np(top: np.ndarray, left: np.ndarray):
    """top[S], left[S] -> b[8] int64 (4 pooled top, then 4 pooled left —
    the order the weight tables were derived in)."""
    s = top.shape[-1]
    pool = s >> 2
    lp = _log2(pool)
    bt = (top[:s].reshape(4, pool).sum(axis=1) + (pool >> 1)) >> lp
    bl = (left[:s].reshape(4, pool).sum(axis=1) + (pool >> 1)) >> lp
    return np.concatenate([bt, bl])


def _upsample_np(red: np.ndarray, top: np.ndarray, left: np.ndarray, s: int):
    """8x8 reduced grid -> SxS, anchored on the original boundary."""
    u = s >> 3
    if u == 1:
        return red
    lu = _log2(u)
    y_anchor = (np.arange(8) + 1) * u - 1
    # horizontal: anchors at x = -1 (left[y_i]) and x = (j+1)u-1 (red[i][j])
    cols = np.concatenate([left[y_anchor][:, None], red], axis=1)  # [8, 9]
    x = np.arange(s)
    j0 = x >> lu
    d = (x & (u - 1)) + 1
    hor = ((u - d)[None, :] * cols[:, j0] + d[None, :] * cols[:, j0 + 1]
           + (u >> 1)) >> lu                                        # [8, S]
    # vertical: anchors at y = -1 (top[x]) and y = (i+1)u-1 (hor[i])
    rows = np.concatenate([top[None, :s], hor], axis=0)             # [9, S]
    out = ((u - d)[:, None] * rows[j0] + d[:, None] * rows[j0 + 1]
           + (u >> 1)) >> lu                                        # [S, S]
    return out


def mip_predict_np(c: np.ndarray, k: int, size: int,
                   bit_depth: int = 8) -> np.ndarray:
    """Predict one SxS block from its reference line C (length 4S+3) with
    MIP mode k.  Returns int32 [S, S]."""
    s = size
    top = c[2 * s + 1: 3 * s + 1].astype(np.int64)
    left = c[2 * s - 1::-1][:s].astype(np.int64)
    b = _reduce_boundary_np(top, left)
    m = (b.sum() + 4) >> 3
    w = mip_weights()[k].astype(np.int64)                 # [64, 8]
    red = ((w @ (b - m)) + 32 >> 6) + m
    red = np.clip(red, 0, (1 << bit_depth) - 1).reshape(8, 8)
    return _upsample_np(red, top, left, s).astype(np.int32)


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

The batched all-modes predictor of the RDO (`mip_predict_all_batch`, port
of vvc/kernels/mip.py:112) runs the hand-written CUDA kernel
`vvc_torch/csrc/mip.cu` on a CUDA tensor, and `mip_predict_all_batch_plain`
(the same integer steps as tensor ops) on a CPU tensor or inside
`ops.plain()`.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from vvc_torch import ops

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



# ---------------------------------------------------------------------------
# Batched torch path — all K modes x all blocks of one size (RDO)
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _up_tables(size: int):
    u = size >> 3
    lu = _log2(u)
    x = np.arange(size)
    return (np.asarray((np.arange(8) + 1) * u - 1, dtype=np.int64),
            np.asarray(x >> lu, dtype=np.int64),
            np.asarray((x & (u - 1)) + 1, dtype=np.int32), u, lu)


@lru_cache(maxsize=None)
def _weights(device: str) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        mip_weights(), dtype=np.int32)).to(device)


def mip_predict_all_batch_plain(c_batch: torch.Tensor, size: int,
                                bit_depth: int = 8) -> torch.Tensor:
    """[N, 4S+3] int32 reference lines → [N, K, S, S] int32 (integer
    semantics identical to mip_predict_np)."""
    s = size
    n = c_batch.shape[0]
    dev = c_batch.device
    c = c_batch.to(torch.int32)
    top = c[:, 2 * s + 1:3 * s + 1]                            # [N, S]
    left = c[:, s:2 * s].flip(1)                               # [N, S]
    pool = s >> 2
    lp = _log2(pool)
    bt = (top.reshape(n, 4, pool).sum(2, dtype=torch.int32)
          + (pool >> 1)) >> lp
    bl = (left.reshape(n, 4, pool).sum(2, dtype=torch.int32)
          + (pool >> 1)) >> lp
    b = torch.cat([bt, bl], dim=1)                             # [N, 8]
    m = (b.sum(1, dtype=torch.int32) + 4) >> 3                 # [N]
    bc = (b - m[:, None]).to(torch.float64)
    w = _weights(str(dev)).to(torch.float64)                   # [K, 64, 8]
    # |w·bc| < 2^53: the float64 product is the exact integer
    red = torch.einsum("koi,ni->nko", w, bc).to(torch.int32)
    red = ((red + 32) >> 6) + m[:, None, None]
    red = red.clamp(0, (1 << bit_depth) - 1).reshape(n, K_MIP_MODES, 8, 8)
    if s == 8:
        return red.contiguous()
    y_anchor, j0, d, u, lu = _up_tables(s)
    y_anchor = torch.from_numpy(y_anchor).to(dev)
    j0 = torch.from_numpy(j0).to(dev)
    d = torch.from_numpy(d).to(dev)
    la = left[:, y_anchor]                                     # [N, 8]
    cols = torch.cat([la[:, None, :, None].expand(n, K_MIP_MODES, 8, 1),
                      red], dim=3)                             # [N, K, 8, 9]
    hor = ((u - d) * cols[..., j0] + d * cols[..., j0 + 1]
           + (u >> 1)) >> lu                                   # [N, K, 8, S]
    rows = torch.cat([top[:, None, None, :].expand(n, K_MIP_MODES, 1, s),
                      hor], dim=2)                             # [N, K, 9, S]
    out = ((u - d)[:, None] * rows[:, :, j0] + d[:, None] * rows[:, :, j0 + 1]
           + (u >> 1)) >> lu
    return out.to(torch.int32).contiguous()


def _mip_cuda(c_batch: torch.Tensor, size: int, bit_depth: int):
    ops.check_cuda_i32("mip_pred_all", c_batch)
    n = c_batch.shape[0]
    if not mip_allowed(size) or c_batch.shape[1] != 4 * size + 3:
        raise ValueError(f"mip_pred_all: unsupported size {size} or refs "
                         f"{tuple(c_batch.shape)}")
    w = _weights(str(c_batch.device))
    out = torch.empty((n, K_MIP_MODES, size, size), dtype=torch.int32,
                      device=c_batch.device)
    if n == 0:
        return out
    fn = ops.lib("mip_pred_all").mip_pred_all_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(c_batch.data_ptr(), w.data_ptr(), out.data_ptr(), n, size,
             bit_depth, ops.stream_ptr(c_batch))
    ops.launched("mip_pred_all", err)
    return out


def mip_predict_all_batch(c_batch: torch.Tensor, size: int,
                          bit_depth: int = 8) -> torch.Tensor:
    """[N, 4S+3] reference lines → [N, K, S, S] MIP predictions."""
    if ops.use_kernel(c_batch):
        return _mip_cuda(c_batch, size, bit_depth)
    return mip_predict_all_batch_plain(c_batch, size, bit_depth)

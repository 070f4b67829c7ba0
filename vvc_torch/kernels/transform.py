"""Forward/inverse block transforms as dense (batched) matrix multiplies.

TPU-native analog of the reference's TrQuant
(`VTM/source/Lib/CommonLib/TrQuant.cpp` → transformNxN /
invTransformNxN; TrQuant_EMT.cpp → fastForwardDCT2_B*, fastForwardDST7_B*,
fastForwardDCT8_B*).  The reference implements each size as a hand-unrolled
butterfly; on TPU the idiomatic form is a dense matmul against the ROM
matrix, batched over many TBs at once so the MXU is fed  (SURVEY.md §2.2:
"Replace butterflies with dense matmul — MXU native, batched over TUs").

Two implementations share the same integer semantics:
  * numpy (`fwd_transform_np` / `inv_transform_np`) — the bit-exact scalar
    oracle used by the sequential reconstruction paths of encoder/decoder.
  * torch (`fwd_transform_batch` / `inv_transform_batch`, ports of
    vvc/kernels/transform.py:78,94) — batched over TBs of one size for the
    lossy RDO search.  A CUDA tensor goes through the hand-written kernels
    of `vvc_torch/csrc/transform.cu` (int32 on CUDA cores); a CPU tensor,
    or any tensor inside `ops.plain()`, through `*_plain`, which does the
    two stages as float64 matmuls (every partial sum is an integer below
    2^53, so float64 is exact) followed by the integer shifts and clamps.

Shift schedule (HEVC/VVC framework, bitDepth B, block W×H, matrices are
6-bit scaled):  forward: stage1 shift = log2(W) + B - 9, stage2 shift =
log2(H) + 6;  inverse: stage1 shift = 7, stage2 shift = 20 - B, with
16-bit clamping of the intermediate (spec 8.7.4; VTM MAX_TR_DYNAMIC_RANGE
= 15).  Coefficients are clipped to [-2^15, 2^15-1].
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from vvc_torch import ops
from vvc_torch.common.types import TrType
from vvc_torch.rom.transform_mats import transform_matrix

# mts_idx → (tr_h, tr_v); reference: TrQuant.cpp → getTrTypes/g_trModes
MTS_TR = ((TrType.DCT2, TrType.DCT2), (TrType.DST7, TrType.DST7),
          (TrType.DCT8, TrType.DST7), (TrType.DST7, TrType.DCT8),
          (TrType.DCT8, TrType.DCT8))


def _log2(n: int) -> int:
    return int(n).bit_length() - 1


def fwd_transform_np(resi: np.ndarray, bit_depth: int = 8,
                     tr_h: int = TrType.DCT2, tr_v: int = TrType.DCT2) -> np.ndarray:
    """Forward 2-D transform of one H×W residual block → H×W coefficients."""
    h, w = resi.shape
    th = transform_matrix(tr_h, w).astype(np.int64)
    tv = transform_matrix(tr_v, h).astype(np.int64)
    shift1 = _log2(w) + bit_depth - 9
    shift2 = _log2(h) + 6
    # horizontal stage: rows of `resi` transformed → tmp[y][u] (u = horizontal freq)
    tmp = (resi.astype(np.int64) @ th.T + (1 << (shift1 - 1))) >> shift1
    # vertical stage
    coeff = (tv @ tmp + (1 << (shift2 - 1))) >> shift2
    return np.clip(coeff, -32768, 32767).astype(np.int32)


def inv_transform_np(coeff: np.ndarray, bit_depth: int = 8,
                     tr_h: int = TrType.DCT2, tr_v: int = TrType.DCT2) -> np.ndarray:
    """Inverse 2-D transform of one H×W coefficient block → H×W residual."""
    h, w = coeff.shape
    th = transform_matrix(tr_h, w).astype(np.int64)
    tv = transform_matrix(tr_v, h).astype(np.int64)
    shift1 = 7
    shift2 = 20 - bit_depth
    # vertical inverse first (transpose of forward order)
    tmp = (tv.T @ coeff.astype(np.int64) + (1 << (shift1 - 1))) >> shift1
    tmp = np.clip(tmp, -32768, 32767)
    resi = (tmp @ th + (1 << (shift2 - 1))) >> shift2
    return np.clip(resi, -32768, 32767).astype(np.int32)


# ---------------------------------------------------------------------------
# Batched torch versions — same integer semantics, leading batch axis.
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _matrix(tr_type: int, n: int, device: str) -> torch.Tensor:
    return torch.from_numpy(np.array(transform_matrix(int(tr_type), n),
                                     dtype=np.int32)).to(device)


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer matmul through float64 (|partial sums| < 2^53)."""
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(
        torch.int64)


def fwd_transform_batch_plain(resi: torch.Tensor, bit_depth: int = 8,
                              tr_h: int = TrType.DCT2,
                              tr_v: int = TrType.DCT2) -> torch.Tensor:
    n, h, w = resi.shape
    dev = str(resi.device)
    th = _matrix(tr_h, w, dev)
    tv = _matrix(tr_v, h, dev)
    shift1 = _log2(w) + bit_depth - 9
    shift2 = _log2(h) + 6
    tmp = (_mm(resi, th.T) + (1 << (shift1 - 1))) >> shift1     # [n,h,u]
    coeff = (_mm(tv, tmp) + (1 << (shift2 - 1))) >> shift2      # [n,v,u]
    return coeff.clamp(-32768, 32767).to(torch.int32)


def inv_transform_batch_plain(coeff: torch.Tensor, bit_depth: int = 8,
                              tr_h: int = TrType.DCT2,
                              tr_v: int = TrType.DCT2) -> torch.Tensor:
    n, h, w = coeff.shape
    dev = str(coeff.device)
    th = _matrix(tr_h, w, dev)
    tv = _matrix(tr_v, h, dev)
    tmp = ((_mm(tv.T, coeff) + (1 << 6)) >> 7).clamp(-32768, 32767)
    shift2 = 20 - bit_depth
    resi = (_mm(tmp, th) + (1 << (shift2 - 1))) >> shift2
    return resi.clamp(-32768, 32767).to(torch.int32)


def _transform_cuda(name: str, x: torch.Tensor, bit_depth: int, tr_h: int,
                    tr_v: int) -> torch.Tensor:
    ops.check_cuda_i32(name, x)
    n, h, w = x.shape
    sides = (4, 8, 16, 32, 64)
    if h not in sides or w not in sides:
        raise ValueError(f"{name}: unsupported block {h}x{w}")
    if ((w == 64 and tr_h != TrType.DCT2)
            or (h == 64 and tr_v != TrType.DCT2)):
        raise ValueError(f"{name}: 64-point transforms are DCT2 only")
    dev = str(x.device)
    th = _matrix(tr_h, w, dev)
    tv = _matrix(tr_v, h, dev)
    out = torch.empty_like(x)
    if n == 0:
        return out
    fn = getattr(ops.lib(name), f"{name}_launch")
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(x.data_ptr(), th.data_ptr(), tv.data_ptr(), out.data_ptr(), n,
             w, h, bit_depth, ops.stream_ptr(x))
    ops.launched(name, err)
    return out


def fwd_transform_batch(resi: torch.Tensor, bit_depth: int = 8,
                        tr_h: int = TrType.DCT2,
                        tr_v: int = TrType.DCT2) -> torch.Tensor:
    """[N, H, W] int32 residuals → [N, H, W] int32 coefficients (W, H ∈
    4..64; a 64-point side is DCT2 only on the card)."""
    if ops.use_kernel(resi):
        return _transform_cuda("transform_fwd", resi, bit_depth, tr_h, tr_v)
    return fwd_transform_batch_plain(resi, bit_depth, tr_h, tr_v)


def inv_transform_batch(coeff: torch.Tensor, bit_depth: int = 8,
                        tr_h: int = TrType.DCT2,
                        tr_v: int = TrType.DCT2) -> torch.Tensor:
    """[N, H, W] int32 coefficients → [N, H, W] int32 residuals (W, H ∈
    4..64; a 64-point side is DCT2 only on the card)."""
    if ops.use_kernel(coeff):
        return _transform_cuda("transform_inv", coeff, bit_depth, tr_h,
                               tr_v)
    return inv_transform_batch_plain(coeff, bit_depth, tr_h, tr_v)

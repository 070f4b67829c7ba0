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

The numpy parts are the recon oracle's (the native reconstruction core
loads the kernels itself).  The batched versions of the RD search's stage C
(ports of vvc/kernels/lfnst.py:84-121) are `fwd_lfnst_batch` and
`inv_lfnst_batch`: on a CUDA tensor they launch the kernels of
vvc_torch/csrc/lfnst.cu, on a CPU tensor or inside `ops.plain()` they run
their plain PyTorch twins.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from vvc_torch import ops
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


# ---------------------------------------------------------------------------
# Batched torch versions ([N, S, S] int32, one lfnst_idx per call)
# ---------------------------------------------------------------------------


def _sets_batch(modes: torch.Tensor):
    """Vectorised lfnst_set over an int32 mode vector → (set [N] int32,
    transpose [N] bool)."""
    modes = modes.to(torch.int32)
    is_mip = modes >= 67
    t = (modes > 34) & ~is_mip
    m = torch.where(t, 68 - modes, modes)
    g = torch.where(m <= 1, 0, torch.where(m <= 12, 1,
                                           torch.where(m <= 23, 2, 3)))
    g = torch.where(is_mip, 0, g)
    return g.to(torch.int32), t


@lru_cache(maxsize=None)
def _kernels_dev(device: str) -> torch.Tensor:
    """The [4, 2, 16, 64] kernels as int8 on `device` (values −45..64, so
    the cast is exact; tests/test_torch_lfnst.py holds that)."""
    return torch.from_numpy(np.ascontiguousarray(
        lfnst_kernels().astype(np.int8))).to(device)


def _gathered(modes: torch.Tensor, lfnst_idx: int, device):
    g, t = _sets_batch(modes)
    b = _kernels_dev(str(device))[:, lfnst_idx - 1][g.long()]   # [N,16,64]
    return b.to(torch.float64), t


def fwd_lfnst_batch_plain(coeff: torch.Tensor, modes: torch.Tensor,
                          lfnst_idx: int) -> torch.Tensor:
    """Plain twin of vvc/kernels/lfnst.py:94 fwd_lfnst_batch.  The int32
    products and sums are exact in float64 (|sum| ≤ 252·32767 < 2^24)."""
    n, s, _ = coeff.shape
    b, t = _gathered(modes, lfnst_idx, coeff.device)
    c8 = coeff[:, :8, :8]
    c8 = torch.where(t[:, None, None], c8.transpose(1, 2), c8)
    y = torch.bmm(b, c8.reshape(n, 64, 1).to(torch.float64))[..., 0]
    y = ((y.to(torch.int32) + 32) >> LFNST_SHIFT).clamp(-32768, 32767)
    out = torch.zeros_like(coeff)
    out[:, :4, :4] = y.reshape(n, 4, 4).to(coeff.dtype)
    return out


def inv_lfnst_batch_plain(deq: torch.Tensor, modes: torch.Tensor,
                          lfnst_idx: int) -> torch.Tensor:
    """Plain twin of vvc/kernels/lfnst.py:109 inv_lfnst_batch (|sum| ≤
    152·32767, exact in float64)."""
    n, s, _ = deq.shape
    b, t = _gathered(modes, lfnst_idx, deq.device)
    y = deq[:, :4, :4].reshape(n, 1, 16).to(torch.float64)
    c8 = torch.bmm(y, b)[:, 0]                                  # [N,64]
    c8 = ((c8.to(torch.int32) + 32) >> LFNST_SHIFT).clamp(-32768, 32767)
    c8 = c8.reshape(n, 8, 8)
    c8 = torch.where(t[:, None, None], c8.transpose(1, 2), c8)
    out = torch.zeros_like(deq)
    out[:, :8, :8] = c8.to(deq.dtype)
    return out


def _lfnst_cuda(name: str, x: torch.Tensor, modes: torch.Tensor,
                lfnst_idx: int) -> torch.Tensor:
    ops.check_cuda_i32(name, x, modes)
    n, h, w = x.shape
    if h != w or w not in (8, 16, 32, 64):
        raise ValueError(f"{name}: unsupported block {h}x{w}")
    if modes.shape != (n,):
        raise ValueError(f"{name}: modes must be [N]")
    if lfnst_idx not in (1, 2):
        raise ValueError(f"{name}: lfnst_idx must be 1 or 2")
    out = torch.empty_like(x)
    if n == 0:
        return out
    fn = getattr(ops.lib(name), f"{name}_launch")
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(x.data_ptr(), modes.data_ptr(),
             _kernels_dev(str(x.device)).data_ptr(), out.data_ptr(), n, w,
             lfnst_idx, ops.stream_ptr(x))
    ops.launched(name, err)
    return out


def fwd_lfnst_batch(coeff: torch.Tensor, modes: torch.Tensor,
                    lfnst_idx: int) -> torch.Tensor:
    """[N,S,S] int32 primary coefficients + [N] int32 modes → [N,S,S]
    secondary-coded blocks (top-left 4×4, the rest zero).  CUDA tensor →
    csrc/lfnst.cu `lfnst_fwd`; CPU tensor or `ops.plain()` → the twin."""
    if ops.use_kernel(coeff):
        return _lfnst_cuda("lfnst_fwd", coeff, modes, lfnst_idx)
    return fwd_lfnst_batch_plain(coeff, modes, lfnst_idx)


def inv_lfnst_batch(deq: torch.Tensor, modes: torch.Tensor,
                    lfnst_idx: int) -> torch.Tensor:
    """[N,S,S] int32 dequantised blocks (secondary coefficients in the
    top-left 4×4) → [N,S,S] primary coefficients (top-left 8×8, the rest
    zero).  CUDA tensor → csrc/lfnst.cu `lfnst_inv`; CPU tensor or
    `ops.plain()` → the twin."""
    if ops.use_kernel(deq):
        return _lfnst_cuda("lfnst_inv", deq, modes, lfnst_idx)
    return inv_lfnst_batch_plain(deq, modes, lfnst_idx)

"""Forward/inverse block transforms as dense (batched) matrix multiplies.

TPU-native analog of the reference's TrQuant
(`VTM/source/Lib/CommonLib/TrQuant.cpp` → transformNxN /
invTransformNxN; TrQuant_EMT.cpp → fastForwardDCT2_B*, fastForwardDST7_B*,
fastForwardDCT8_B*).  The reference implements each size as a hand-unrolled
butterfly; on TPU the idiomatic form is a dense matmul against the ROM
matrix, batched over many TBs at once so the MXU is fed  (SURVEY.md §2.2:
"Replace butterflies with dense matmul — MXU native, batched over TUs").

This copy holds the numpy implementation (`fwd_transform_np` /
`inv_transform_np`), the bit-exact scalar oracle used by the sequential
reconstruction paths of encoder/decoder.  The batched device versions used
by the lossy RDO search arrive with the lossy All-Intra slice.

Shift schedule (HEVC/VVC framework, bitDepth B, block W×H, matrices are
6-bit scaled):  forward: stage1 shift = log2(W) + B - 9, stage2 shift =
log2(H) + 6;  inverse: stage1 shift = 7, stage2 shift = 20 - B, with
16-bit clamping of the intermediate (spec 8.7.4; VTM MAX_TR_DYNAMIC_RANGE
= 15).  Coefficients are clipped to [-2^15, 2^15-1].
"""
from __future__ import annotations

import numpy as np

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
# Batched JAX versions — same integer semantics, leading batch axis.
# ---------------------------------------------------------------------------

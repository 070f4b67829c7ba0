"""Scalar quantization / dequantization (uniform reconstruction quantizer).

TPU-native analog of the reference's Quant
(`VTM/source/Lib/CommonLib/Quant.cpp` → Quant::quant /
Quant::dequant, g_quantScales/g_invQuantScales).  Elementwise — runs on the
VPU; batched over TBs.  RDOQ / dependent quantization (QuantRDOQ.cpp /
DepQuant.cpp) layer on top of this in vvc_torch.enc (trellis via lax.scan,
SURVEY.md §2.2).

Semantics (HEVC/VVC framework):
  transformShift = MAX_TR_DYNAMIC_RANGE - bitDepth - (log2W + log2H)/2
  qbits  = QUANT_SHIFT + qp/6 + transformShift
  level  = sign(c) * ((|c| * quantScale[qp%6] + offset) >> qbits)
  dequant: c' = clip16( (level * invQuantScale[qp%6] << (qp/6) + (1<<(sh-1))) >> sh ),
           sh = IQUANT_SHIFT - transformShift   (when >0; else left shift)
Rectangular blocks with odd (log2W+log2H) use the sqrt(2) compensation
(scale 181/256) — [verify] exact VVC rounding once the reference mount is
populated; QT-only round-1 paths are all square.
"""
from __future__ import annotations

import numpy as np

from vvc_torch.common.types import MAX_TR_DYNAMIC_RANGE
from vvc_torch.rom.transform_mats import (QUANT_SCALES, INV_QUANT_SCALES,
                                    QUANT_SCALES_RECT, INV_QUANT_SCALES_RECT,
                                    QUANT_SHIFT, IQUANT_SHIFT)


def _log2(n: int) -> int:
    return int(n).bit_length() - 1


def transform_shift(log2_w: int, log2_h: int, bit_depth: int) -> int:
    return MAX_TR_DYNAMIC_RANGE - bit_depth - ((log2_w + log2_h) >> 1)


def quant_np(coeff: np.ndarray, qp: int, bit_depth: int = 8, intra: bool = True) -> np.ndarray:
    """One H×W int32 coefficient block → quantized levels (int32).

    Uses the standard rounding offset (1/3 inter, ~1/3 intra — VTM uses 171/512
    for intra and 85/512 for inter as the dead-zone offset).
    """
    h, w = coeff.shape
    tshift = transform_shift(_log2(w), _log2(h), bit_depth)
    qbits = QUANT_SHIFT + qp // 6 + tshift
    rect = (_log2(w) + _log2(h)) & 1
    scale = int((QUANT_SCALES_RECT if rect else QUANT_SCALES)[qp % 6])
    offset = (171 if intra else 85) << (qbits - 9)
    # |coeff| <= 2^15, scale < 2^15 → product < 2^30: int64 never needed
    a = np.abs(coeff.astype(np.int64))
    level = (a * scale + offset) >> qbits
    level = np.clip(level, 0, 32767)
    return (np.sign(coeff) * level).astype(np.int32)


# pre-shift magnitude guard for dequant: values beyond this saturate the
# 16-bit coefficient clip regardless of the final shift, so clamping the
# intermediate keeps int32 arithmetic exact (shared by the np and batched paths)
_DEQ_GUARD = 1 << 29


def dequant_np(level: np.ndarray, qp: int, bit_depth: int = 8) -> np.ndarray:
    """Quantized levels → reconstructed coefficients (int32, 16-bit clipped)."""
    h, w = level.shape
    tshift = transform_shift(_log2(w), _log2(h), bit_depth)
    shift = IQUANT_SHIFT - tshift
    rect = (_log2(w) + _log2(h)) & 1
    scale = int((INV_QUANT_SCALES_RECT if rect else INV_QUANT_SCALES)[qp % 6])
    sh6 = qp // 6
    lv = level.astype(np.int64) * scale            # < 2^22, int32-safe too
    lv = np.clip(lv, -(_DEQ_GUARD >> sh6), _DEQ_GUARD >> sh6) << sh6
    if shift > 0:
        c = (lv + (1 << (shift - 1))) >> shift
    else:
        c = lv << (-shift)
    return np.clip(c, -32768, 32767).astype(np.int32)


# ---------------------------------------------------------------------------
# Batched JAX versions ([N, H, W], all blocks same size & qp for one call).
# ---------------------------------------------------------------------------

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

import ctypes
from functools import lru_cache

import numpy as np
import torch

from vvc_torch import ops

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
# Batched torch versions ([N, H, W], all blocks same size & qp for one call)
# — ports of vvc/kernels/quant.py:87,106, int32 arithmetic like the
# reference's (arithmetic shifts, the _DEQ_GUARD clamp, dead-zone offset
# 171 intra, 85 inter).
# ---------------------------------------------------------------------------


def _quant_params(h: int, w: int, qp: int, bit_depth: int, intra: bool):
    tshift = transform_shift(_log2(w), _log2(h), bit_depth)
    rect = (_log2(w) + _log2(h)) & 1
    qbits = QUANT_SHIFT + qp // 6 + tshift
    scale = int((QUANT_SCALES_RECT if rect else QUANT_SCALES)[qp % 6])
    offset = (171 if intra else 85) << (qbits - 9)
    return scale, offset, qbits


def _dequant_params(h: int, w: int, qp: int, bit_depth: int):
    tshift = transform_shift(_log2(w), _log2(h), bit_depth)
    shift = IQUANT_SHIFT - tshift
    rect = (_log2(w) + _log2(h)) & 1
    scale = int((INV_QUANT_SCALES_RECT if rect else INV_QUANT_SCALES)[qp % 6])
    return scale, qp // 6, shift


def quant_batch(coeff: torch.Tensor, qp: int, bit_depth: int = 8,
                intra: bool = True) -> torch.Tensor:
    """[N,H,W] int32 coefficients → int32 levels (plain torch, any device;
    the RDO's device pass fuses it into `quant_rate`)."""
    n, h, w = coeff.shape
    scale, offset, qbits = _quant_params(h, w, int(qp), bit_depth, intra)
    c = coeff.to(torch.int32)
    level = ((c.abs() * scale + offset) >> qbits).clamp(0, 32767)
    return (torch.sign(c) * level).to(torch.int32)


def dequant_batch(level: torch.Tensor, qp: int,
                  bit_depth: int = 8) -> torch.Tensor:
    """[N,H,W] int32 levels → int32 coefficients, 16-bit clipped."""
    n, h, w = level.shape
    scale, sh6, shift = _dequant_params(h, w, int(qp), bit_depth)
    g = _DEQ_GUARD >> sh6
    lv = (level.to(torch.int32) * scale).clamp(-g, g) << sh6
    if shift > 0:
        c = (lv + (1 << (shift - 1))) >> shift
    else:
        c = lv << (-shift)
    return c.clamp(-32768, 32767).to(torch.int32)


# ---------------------------------------------------------------------------
# Float32 block sums in the order XLA-CPU's fused RDO program uses.
#
# vvc's `jnp.sum(x, axis=(1, 2))` over [M, S, S] float32 inside the jitted
# eval_blocks is a reduction LLVM vectorises 8 lanes wide (reassociation
# allowed), so the last bits of every rate (a sum of non-integer level
# bits) follow its order, read from the optimised IR of that program:
#   S = 8, 16, 32: for each row v, lanes k = 0..7 take the row's parts
#     P_p = x[v, 8p:8p+8]; the running sum s joins lane 0 of P_0; the
#     parts are combined as R = P_p + R for p = 1 .. S/8-1; then
#     s = ((R0+R4)+(R2+R6)) + ((R1+R5)+(R3+R7)).
#   S = 64: the reduction is split into 32×32 windows, each summed
#     sequentially row-major from 0; then (W00 + W01) + (W10 + W11).
#   Row lanes (S = 8..32), where LLVM unrolls the column loop and
#     vectorises the row loop instead: lane v sums rows v, v+8, ... in
#     turn, each left to right; then the same tree.
# ---------------------------------------------------------------------------


def _tree8(r: torch.Tensor) -> torch.Tensor:
    """XLA's horizontal add of 8 lanes (last axis)."""
    return (((r[..., 0] + r[..., 4]) + (r[..., 2] + r[..., 6]))
            + ((r[..., 1] + r[..., 5]) + (r[..., 3] + r[..., 7])))


def xla_block_sum(x: torch.Tensor, row_lanes: bool = False,
                  tail: bool = False) -> torch.Tensor:
    """[M, S, S] float32 → [M] float32, summed in XLA-CPU's order.
    row_lanes (S ≤ 32): vectorised the other way round — lane v sums rows
    v, v+8, ... left to right, then the 8 lanes meet in the same halving
    tree.  The order of the 8×8 SSE, of the LFNST stage's 8×8 rate and of
    the chroma decision's CCLM sums.
    tail (S = 16, 32): row by row, columns 0..S-9 lane-wise (lane v sums
    columns v, v+8, ..., the running total joining lane 0), the halving
    tree, then the last 8 columns added one by one — the order of some
    chroma sums in the vmapped tile program."""
    m, s, s2 = x.shape
    assert s == s2 and s in (8, 16, 32, 64), x.shape
    x = x.to(torch.float32)
    if tail:
        assert s in (16, 32), x.shape
        tot = torch.zeros((m,), dtype=torch.float32, device=x.device)
        for v in range(s):
            lanes = x[:, v, 0:8].clone()
            lanes[:, 0] = tot + x[:, v, 0]
            for p in range(8, s - 8, 8):
                lanes = lanes + x[:, v, p:p + 8]
            tot = _tree8(lanes)
            for j in range(s - 8, s):
                tot = tot + x[:, v, j]
        return tot
    if row_lanes:
        assert s <= 32, x.shape
        acc = x[:, 0:8, 0]
        for r in range(0, s, 8):
            for j in range(int(r == 0), s):
                acc = acc + x[:, r:r + 8, j]
        return _tree8(acc)
    if s == 64:
        win = x.reshape(m, 2, 32, 2, 32).permute(0, 1, 3, 2, 4).reshape(
            m, 2, 2, 1024)
        acc = torch.zeros((m, 2, 2), dtype=torch.float32, device=x.device)
        for i in range(1024):
            acc = acc + win[..., i]
        return (acc[:, 0, 0] + acc[:, 0, 1]) + (acc[:, 1, 0] + acc[:, 1, 1])
    parts = x.reshape(m, s, s // 8, 8)
    lanes = parts[:, :, 0, :]
    for p in range(1, s // 8):
        lanes = parts[:, :, p, :] + lanes     # lanes 1..7: no running sum
    tot = torch.zeros((m,), dtype=torch.float32, device=x.device)
    for v in range(s):
        lane0 = tot + parts[:, v, 0, 0]
        for p in range(1, s // 8):
            lane0 = parts[:, v, p, 0] + lane0
        r = torch.cat([lane0[:, None], lanes[:, v, 1:]], dim=1)
        tot = _tree8(r)
    return tot


# ---------------------------------------------------------------------------
# Fused quantise → level rate → dequantise (the RDO's device pass)
# ---------------------------------------------------------------------------


def quant_rate_plain(coeff: torch.Tensor, qp: int, bit_depth: int = 8,
                     row_lanes: bool = False, intra: bool = True):
    """Plain twin of the `quant_rate` kernel: the composition of
    quant_batch, level_bits and dequant_batch, with the rate summed per
    block in XLA's order.  → (rate [N] f32, dequantised [N,S,S] i32); the
    levels are not returned, as the kernel does not write them."""
    from vvc_torch.cabac.rates import level_bits
    lev = quant_batch(coeff, qp, bit_depth, intra=intra)
    rate = xla_block_sum(level_bits(lev.abs()), row_lanes)
    return rate, dequant_batch(lev, qp, bit_depth)


@lru_cache(maxsize=None)
def _rate_tables(device: str):
    from vvc_torch.cabac.rates import LEVEL_BITS_TABLE
    from vvc_torch.rom.log_table import xla_log_f32
    return (torch.from_numpy(xla_log_f32().copy()).to(device),
            torch.from_numpy(LEVEL_BITS_TABLE.copy()).to(device))


def _quant_rate_cuda(coeff: torch.Tensor, qp: int, bit_depth: int,
                     row_lanes: bool, intra: bool):
    from vvc_torch.cabac.rates import log_scale_f32
    ops.check_cuda_i32("quant_rate", coeff)
    n, h, w = coeff.shape
    if h != w or w not in (8, 16, 32, 64):
        raise ValueError(f"quant_rate: unsupported block {h}x{w}")
    if row_lanes and w != 8:
        raise ValueError("quant_rate: row_lanes is an 8x8 order")
    scale, offset, qbits = _quant_params(h, w, int(qp), bit_depth, intra)
    dscale, sh6, shift = _dequant_params(h, w, int(qp), bit_depth)
    if shift <= 0:
        raise ValueError("quant_rate: dequant shift must be positive")
    log_tab, base_tab = _rate_tables(str(coeff.device))
    deq = torch.empty_like(coeff)
    rate = torch.empty((n,), dtype=torch.float32, device=coeff.device)
    if n == 0:
        return rate, deq
    fn = ops.lib("quant_rate").quant_rate_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
                   + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int,
                                            ctypes.c_void_p])
    fn.restype = ctypes.c_int
    err = fn(coeff.data_ptr(), log_tab.data_ptr(), base_tab.data_ptr(),
             deq.data_ptr(), rate.data_ptr(), n, w,
             scale, offset, qbits, dscale, sh6, shift,
             float(log_scale_f32()), int(row_lanes), ops.stream_ptr(coeff))
    ops.launched("quant_rate", err)
    return rate, deq


def quant_rate(coeff: torch.Tensor, qp: int, bit_depth: int = 8,
               row_lanes: bool = False, intra: bool = True):
    """[N,S,S] int32 coefficients → (rate [N] f32, dequantised [N,S,S]
    i32).  One pass of vvc's quant_batch,
    level_bits_jnp + sum and dequant_batch (vvc/kernels/quant.py:87,106,
    vvc/cabac/rates.py:41).  row_lanes (S = 8 only): sum the rate in the
    order XLA gives the 8×8 reduction of the LFNST stage (each row in its
    own lane, then the lane tree) instead of the stages-A/B order.  intra
    picks the dead zone: offset 171/512 (intra search) or 85/512 (the
    inter search's `_inter_rd_dev`).  CUDA tensor →
    vvc_torch/csrc/quant_rate.cu; CPU tensor or `ops.plain()` →
    quant_rate_plain."""
    if ops.use_kernel(coeff):
        return _quant_rate_cuda(coeff, qp, bit_depth, row_lanes, intra)
    return quant_rate_plain(coeff, qp, bit_depth, row_lanes, intra)

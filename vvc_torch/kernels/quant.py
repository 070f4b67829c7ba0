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


def dequant_batch_plain(level: torch.Tensor, qp: int,
                        bit_depth: int = 8) -> torch.Tensor:
    """[N,H,W] int32 levels → int32 coefficients, 16-bit clipped (the
    plain twin of the `dequant` kernel)."""
    n, h, w = level.shape
    scale, sh6, shift = _dequant_params(h, w, int(qp), bit_depth)
    g = _DEQ_GUARD >> sh6
    lv = (level.to(torch.int32) * scale).clamp(-g, g) << sh6
    if shift > 0:
        c = (lv + (1 << (shift - 1))) >> shift
    else:
        c = lv << (-shift)
    return c.clamp(-32768, 32767).to(torch.int32)


def _dequant_cuda(level: torch.Tensor, qp: int,
                  bit_depth: int) -> torch.Tensor:
    ops.check_cuda_i32("dequant", level)
    n, h, w = level.shape
    scale, sh6, shift = _dequant_params(h, w, int(qp), bit_depth)
    out = torch.empty_like(level)
    if level.numel() == 0:
        return out
    fn = ops.lib("dequant").dequant_launch
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(level.data_ptr(), out.data_ptr(), n, w, h, scale, sh6, shift,
             ops.stream_ptr(level))
    ops.launched("dequant", err)
    return out


def dequant_batch(level: torch.Tensor, qp: int,
                  bit_depth: int = 8) -> torch.Tensor:
    """[N,H,W] int32 levels → int32 coefficients, 16-bit clipped: port of
    vvc/kernels/quant.py:106, the decoder's dequantisation (the RD search
    fuses it into `quant_rate`).  CUDA tensor → csrc/quant_rate.cu
    `dequant`; CPU tensor or `ops.plain()` → dequant_batch_plain."""
    if ops.use_kernel(level):
        return _dequant_cuda(level, qp, bit_depth)
    return dequant_batch_plain(level, qp, bit_depth)


# ---------------------------------------------------------------------------
# Float32 block sums in the order XLA-CPU's fused RDO program uses.
#
# vvc's `jnp.sum(x, axis=(1, 2))` over [M, H, W] float32 inside the jitted
# search is a reduction LLVM vectorises 8 lanes wide (reassociation
# allowed), so the last bits of every rate (a sum of non-integer level
# bits) follow its order, read from the optimised IR of that program:
#   default (W = 8, 16, 32): for each row v, lanes k = 0..7 take the row's
#     parts P_p = x[v, 8p:8p+8]; the running sum s joins lane 0 of P_0;
#     the parts are combined as R = P_p + R for p = 1 .. W/8-1; then
#     s = ((R0+R4)+(R2+R6)) + ((R1+R5)+(R3+R7)).
#   A side of 64: the reduction is split into windows of
#     min(H, 32) × min(W, 32), each summed sequentially row-major from 0;
#     then W0 + W1, or (W00 + W01) + (W10 + W11).
#   Row lanes (H = 4..32), where LLVM vectorises the row loop instead:
#     lane v sums rows v, v+8, ... in turn, each left to right; then the
#     same tree (4 rows: 4 lanes, then (l0+l2)+(l1+l3)).
#   Tail (W = 16, 32): per row, columns 0..W-9 as in the default order,
#     the tree, then the last 8 columns added one by one.
#   Part order (W = 16, 32): per row, the parts added onto the running
#     total in a given order (the x86 backend's FMA chain), then the tree.
# ---------------------------------------------------------------------------


def _tree8(r: torch.Tensor) -> torch.Tensor:
    """XLA's horizontal add of 8 lanes (last axis)."""
    return (((r[..., 0] + r[..., 4]) + (r[..., 2] + r[..., 6]))
            + ((r[..., 1] + r[..., 5]) + (r[..., 3] + r[..., 7])))


def rate_order(h: int, w: int) -> dict:
    """The order of vvc's level-rate sum over an H×W block in its search
    program (stages A and B, the ISP sub-TUs and the TT mid planes; read
    from the optimised LLVM IR, one reduction per shape): row lanes where
    the block is 4 wide, the tail order where it has at most 8 rows and
    16 or 32 columns, else the default (windows at a side of 64)."""
    if w == 4:
        return {"row_lanes": True}
    if h <= 8 and w in (16, 32):
        return {"tail": True}
    return {}


def xla_block_sum(x: torch.Tensor, row_lanes: bool = False,
                  tail: bool = False, part_order: tuple | None = None
                  ) -> torch.Tensor:
    """[M, H, W] float32 → [M] float32, summed in XLA-CPU's order (H, W ∈
    4..64).  Default: see above (W ≥ 8; windows at a side of 64).
    row_lanes (H = 4..32): lane v sums rows v, v+8, ... left to right,
    then the 8 lanes meet in the halving tree (4 rows: 4 lanes, then
    (l0+l2)+(l1+l3)) — the order of the 8×8 SSE, of the LFNST stage's 8×8
    rate, of the chroma decision's CCLM sums, of the 4-wide rates and of
    most 8-wide SSEs.
    tail (W = 16, 32): row by row, columns 0..W-9 lane-wise (lane v sums
    columns v, v+8, ..., the running total joining lane 0), the halving
    tree, then the last 8 columns added one by one — the order of the
    rates of blocks with at most 8 rows, and of some chroma sums in the
    vmapped tile program.
    part_order (W = 16, 32): the default order with the row's parts of 8
    added onto the running total in this order, e.g. (0, 2, 3, 1):
    (((s + P0) + P2) + P3) + P1 — the order the x86 backend gives some
    SSE sums of vvc's MTT search program, where it turns the vectorised
    adds into one chain of FMAs."""
    m, h, w = x.shape
    assert h in (4, 8, 16, 32, 64) and w in (4, 8, 16, 32, 64), x.shape
    x = x.to(torch.float32)
    if tail:
        assert w in (16, 32), x.shape
        tot = torch.zeros((m,), dtype=torch.float32, device=x.device)
        for v in range(h):
            lanes = x[:, v, 0:8].clone()
            lanes[:, 0] = tot + x[:, v, 0]
            for p in range(8, w - 8, 8):
                lanes = lanes + x[:, v, p:p + 8]
            tot = _tree8(lanes)
            for j in range(w - 8, w):
                tot = tot + x[:, v, j]
        return tot
    if row_lanes:
        assert 4 <= h <= 32, x.shape
        nl = min(h, 8)                  # 4 rows: 4 lanes, then their tree
        acc = x[:, 0:nl, 0]
        for r in range(0, h, nl):
            for j in range(int(r == 0), w):
                acc = acc + x[:, r:r + nl, j]
        if nl == 4:
            return (acc[:, 0] + acc[:, 2]) + (acc[:, 1] + acc[:, 3])
        return _tree8(acc)
    if h == 64 or w == 64:
        wh, ww = min(h, 32), min(w, 32)
        ny, nx = h // wh, w // ww
        win = x.reshape(m, ny, wh, nx, ww).permute(0, 1, 3, 2, 4).reshape(
            m, ny, nx, wh * ww)
        acc = torch.zeros((m, ny, nx), dtype=torch.float32, device=x.device)
        for i in range(wh * ww):
            acc = acc + win[..., i]
        if ny * nx == 4:
            return ((acc[:, 0, 0] + acc[:, 0, 1])
                    + (acc[:, 1, 0] + acc[:, 1, 1]))
        acc = acc.reshape(m, 2)
        return acc[:, 0] + acc[:, 1]
    assert w >= 8, x.shape
    parts = x.reshape(m, h, w // 8, 8)
    tot = torch.zeros((m,), dtype=torch.float32, device=x.device)
    for v in range(h):
        order = part_order or range(w // 8)
        lanes = parts[:, v, order[0]].clone()
        lanes[:, 0] = tot + lanes[:, 0]
        for p in order[1:]:
            lanes = lanes + parts[:, v, p]
        tot = _tree8(lanes)
    return tot


# ---------------------------------------------------------------------------
# Fused quantise → level rate → dequantise (the RDO's device pass)
# ---------------------------------------------------------------------------


def _rate_order(h: int, w: int, row_lanes: bool) -> dict:
    """The sum order of a quant_rate call: row lanes where the caller asks
    for them (the LFNST stage's 8×8 rate), else vvc's for the shape."""
    return {"row_lanes": True} if row_lanes else rate_order(h, w)


def quant_rate_plain(coeff: torch.Tensor, qp: int, bit_depth: int = 8,
                     row_lanes: bool = False, intra: bool = True):
    """Plain twin of the `quant_rate` kernel: the composition of
    quant_batch, level_bits and dequant_batch, with the rate summed per
    block in XLA's order.  → (rate [N] f32, dequantised [N,H,W] i32); the
    levels are not returned, as the kernel does not write them."""
    from vvc_torch.cabac.rates import level_bits
    lev = quant_batch(coeff, qp, bit_depth, intra=intra)
    h, w = coeff.shape[1:]
    rate = xla_block_sum(level_bits(lev.abs()), **_rate_order(h, w,
                                                               row_lanes))
    return rate, dequant_batch_plain(lev, qp, bit_depth)


@lru_cache(maxsize=None)
def _rate_tables(device: str):
    from vvc_torch.cabac.rates import LEVEL_BITS_TABLE
    from vvc_torch.rom.log_table import xla_log_f32
    return (torch.from_numpy(xla_log_f32().copy()).to(device),
            torch.from_numpy(LEVEL_BITS_TABLE.copy()).to(device))


_SIDES = (4, 8, 16, 32, 64)


def _quant_rate_cuda(coeff: torch.Tensor, qp: int, bit_depth: int,
                     row_lanes: bool, intra: bool):
    from vvc_torch.cabac.rates import log_scale_f32
    ops.check_cuda_i32("quant_rate", coeff)
    n, h, w = coeff.shape
    if h not in _SIDES or w not in _SIDES or h * w < 32:
        raise ValueError(f"quant_rate: unsupported block {h}x{w}")
    order = _rate_order(h, w, row_lanes)
    if order.get("row_lanes") and not (h == 4 or 8 <= h <= 32):
        raise ValueError(f"quant_rate: row lanes need 4 or 8..32 rows, "
                         f"not {h}")
    if not order and w == 4:
        raise ValueError("quant_rate: a 4-wide block sums in row lanes")
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
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                   + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int,
                                            ctypes.c_void_p])
    fn.restype = ctypes.c_int
    mode = 1 if order.get("row_lanes") else (2 if order.get("tail") else 0)
    err = fn(coeff.data_ptr(), log_tab.data_ptr(), base_tab.data_ptr(),
             deq.data_ptr(), rate.data_ptr(), n, w, h,
             scale, offset, qbits, dscale, sh6, shift,
             float(log_scale_f32()), mode, ops.stream_ptr(coeff))
    ops.launched("quant_rate", err)
    return rate, deq


def quant_rate(coeff: torch.Tensor, qp: int, bit_depth: int = 8,
               row_lanes: bool = False, intra: bool = True):
    """[N,H,W] int32 coefficients → (rate [N] f32, dequantised [N,H,W]
    i32), H, W ∈ 4..64.  One pass of vvc's quant_batch,
    level_bits_jnp + sum and dequant_batch (vvc/kernels/quant.py:87,106,
    vvc/cabac/rates.py:41).  The rate is summed in the order XLA gives
    vvc's search program for the shape (`rate_order`); row_lanes (8×8):
    in the order of the LFNST stage's rate instead (each row in its own
    lane, then the lane tree).  intra picks the dead zone: offset 171/512
    (intra search) or 85/512 (the inter search's `_inter_rd_dev`).  CUDA
    tensor → vvc_torch/csrc/quant_rate.cu; CPU tensor or `ops.plain()` →
    quant_rate_plain."""
    if ops.use_kernel(coeff):
        return _quant_rate_cuda(coeff, qp, bit_depth, row_lanes, intra)
    return quant_rate_plain(coeff, qp, bit_depth, row_lanes, intra)

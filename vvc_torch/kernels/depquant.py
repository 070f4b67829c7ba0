"""Dependent quantization: 4-state trellis quantizer + state-tracking
dequant (VVC's main scalar-quant upgrade, ~+2% BD-rate in the reference).

TPU-native analog of the reference's DepQuant
(`VTM/source/Lib/CommonLib/DepQuant.cpp` → DQIntern::DepQuant:
two interleaved quantizers Q0/Q1 selected by a 4-state machine driven by
level parities, Viterbi search over scan positions; decoder side: state-
dependent reconstruction in spec 8.7.3).  OpenVVC: rcn_dequant.c.

Design notes:
  - State transition table QStateTransTable[state][parity] =
    {{0,2},{2,0},{1,3},{3,1}} (spec table).  Q0 active in states 0/1,
    Q1 in states 2/3; reconstruction r = (2·|l| − (state>1)) · Δ/2 for
    |l|>0, r = 0 for l = 0.
  - The state walk starts at the TOP of the scan (position S²−1) instead
    of the last significant coefficient: zeros keep state 0 (parity-0
    transition of state 0 is 0), so both conventions reconstruct
    identically while making decode a pure post-pass over parsed levels —
    no CABAC-layer coupling, and the batched device path stays intact.
  - Encoder trellis cost is computed in normalized half-step units where
    λ becomes a QP-independent constant (λ·Δ⁻² ∝ const) — rate model is
    the same heuristic the RDO search uses (non-normative).
"""
from __future__ import annotations

import numpy as np

from vvc_torch.kernels.quant import transform_shift, _log2
from vvc_torch.rom.transform_mats import (QUANT_SCALES, INV_QUANT_SCALES,
                                    QUANT_SHIFT, IQUANT_SHIFT)
from vvc_torch.cabac.residual import full_scan_rect

# QStateTransTable[state][parity]
NEXT_STATE = ((0, 2), (2, 0), (1, 3), (3, 1))

# λ in normalized half-step units (see module docstring), used with the
# MEASURED level-rate table (vvc_torch.cabac.rates — fit against this repo's own
# residual coder output, the estFracBits analog).  Calibrated by RD sweep
# at QP {27, 32, 37} on the synth corpus so dep-quant RD-dominates scalar
# quant (see vvc's tests/test_depquant.py::test_rd_not_worse_than_scalar).
LAMBDA_T = 0.45

from vvc_torch.cabac.rates import level_bits_scalar as _level_bits

# small cache of the measured per-level rates used in the trellis hot loop
_RATE_LUT = [_level_bits(l) for l in range(64)]


def _dequant_native(l, levels, w, h, qp, bit_depth):
    import ctypes
    lv = np.ascontiguousarray(levels, dtype=np.int32)
    out = np.empty_like(lv)
    l.dequant_depquant_c(lv.ctypes.data_as(ctypes.c_void_p), w, h,
                         qp, bit_depth, out.ctypes.data_as(ctypes.c_void_p))
    return out


def _quant_native(l, coeff, w, h, qp, bit_depth, lam_t):
    import ctypes
    cf = np.ascontiguousarray(coeff, dtype=np.int32)
    out = np.empty_like(cf)
    l.quant_depquant_c(cf.ctypes.data_as(ctypes.c_void_p), w, h,
                       qp, bit_depth, float(lam_t),
                       out.ctypes.data_as(ctypes.c_void_p))
    return out


def _native():
    """The recon core's dep-quant pair.  Bit-identical to the numpy
    oracles below (same double-precision op order in the trellis, same
    uploaded rate LUT) — held by tests/test_torch_mtt.py.  The core is
    built at first use; a failed build raises (no fallback)."""
    from vvc_torch.packer import native_recon
    from vvc_torch.packer import recon_lib
    native_recon.available()
    return recon_lib()


def dequant_depquant_np(levels: np.ndarray, qp: int,
                        bit_depth: int = 8) -> np.ndarray:
    """State-tracking dequantization (decoder + encoder recon shared).

    levels: int32 [S,S] quantized levels → int32 coefficients."""
    h, w = levels.shape
    l = _native()
    if l is not None:
        return _dequant_native(l, levels, w, h, qp, bit_depth)
    tshift = transform_shift(_log2(w), _log2(h), bit_depth)
    shift = IQUANT_SHIFT - tshift + 1          # +1: half-step granularity
    scale = int(INV_QUANT_SCALES[qp % 6])
    sh6 = qp // 6
    scan = full_scan_rect(_log2(w), _log2(h))   # forward scan (DC first)
    out = np.zeros_like(levels)
    state = 0
    for x, y in reversed(scan):                 # coding order: high→DC
        l = int(levels[y, x])
        if l != 0:
            a = abs(l)
            t = 2 * a - (1 if state > 1 else 0)
            v = (t * scale) << sh6
            if shift > 0:
                c = (v + (1 << (shift - 1))) >> shift
            else:
                c = v << (-shift)
            out[y, x] = np.clip(c if l > 0 else -c, -32768, 32767)
        state = NEXT_STATE[state][abs(l) & 1]
    return out


def quant_depquant_np(coeff: np.ndarray, qp: int, bit_depth: int = 8,
                      lam_t: float | None = None) -> np.ndarray:
    """Viterbi trellis quantization over the scan (encoder only).

    coeff: int32 [S,S] transform coefficients → int32 levels whose
    dequant_depquant_np reconstruction minimizes D + λ·R along the path.
    """
    if lam_t is None:
        lam_t = LAMBDA_T
    h, w = coeff.shape
    l = _native()
    if l is not None:
        return _quant_native(l, coeff, w, h, qp, bit_depth, lam_t)
    tshift = transform_shift(_log2(w), _log2(h), bit_depth)
    qbits = QUANT_SHIFT + qp // 6 + tshift
    scale = int(QUANT_SCALES[qp % 6])
    scan = full_scan_rect(_log2(w), _log2(h))
    n = len(scan)
    # normalized magnitudes in half-step units
    t_mag = np.empty(n)
    signs = np.empty(n, dtype=np.int32)
    for i, (x, y) in enumerate(reversed(scan)):
        c = int(coeff[y, x])
        t_mag[i] = abs(c) * scale / (1 << (qbits - 1))
        signs[i] = 1 if c >= 0 else -1

    def rate(l):
        return _RATE_LUT[l] if l < 64 else _level_bits(l)

    def recon(l, state):
        return 0.0 if l == 0 else 2.0 * l - (1.0 if state > 1 else 0.0)

    INF = float("inf")
    cost = [0.0, INF, INF, INF]
    # choices[i][state] = (level, prev_state)
    choices = np.zeros((n, 4, 2), dtype=np.int32)
    for i in range(n):
        t = t_mag[i]
        ncost = [INF] * 4
        nchoice = [(0, 0)] * 4
        for s in range(4):
            if cost[s] == INF:
                continue
            base = int(t / 2) if s < 2 else int((t + 1) / 2)
            for l in {0, max(0, base), base + 1}:
                d = (t - recon(l, s)) ** 2
                c = cost[s] + d + lam_t * rate(l)
                ns = NEXT_STATE[s][l & 1]
                if c < ncost[ns]:
                    ncost[ns] = c
                    nchoice[ns] = (l, s)
        cost = ncost
        choices[i, :, 0] = [ch[0] for ch in nchoice]
        choices[i, :, 1] = [ch[1] for ch in nchoice]
    # backtrack from the best final state
    out = np.zeros_like(coeff)
    s = int(np.argmin(cost))
    rscan = list(reversed(scan))
    for i in range(n - 1, -1, -1):
        l, ps = int(choices[i, s, 0]), int(choices[i, s, 1])
        x, y = rscan[i]
        out[y, x] = signs[i] * l
        s = ps
    return out

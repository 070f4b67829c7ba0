"""Intra fractional-interpolation filter ROM (4-tap, 32 phases).

TPU-native analog of the reference's intra interpolation filters
(`VTM/source/Lib/CommonLib/Rom.cpp` -> g_intraGaussFilter /
the cubic fC set used by IntraPrediction::xPredIntraAng).  The reference
publishes spec-constant tables; ours are derived in closed form from the
same mathematical objects so no table is copied:

  fC: Catmull-Rom cubic (the interpolating cubic the spec's DCT-IF
      approximates) -- identity at phase 0, sharp.
  fG: uniform cubic B-spline (the spec's Gaussian-like smoother IS the
      B-spline kernel) -- smoothing even at phase 0.

All values are exact integers (rational arithmetic, floor-rounded, then
sum-corrected to 64 on the centre tap) so encoder, decoder, and the C++
core share bit-identical constants with no float involvement.

Filter choice per (mode, size): use fG when the mode's angular distance
from pure horizontal/vertical exceeds a per-size threshold (reference
IntraPrediction::useFilteredIntraRefSamples shape, [verify] exact spec
thresholds) -- see `use_smooth_filter`.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

# min(|mode-18|, |mode-50|) must EXCEED this for fG; by log2(size) 2..6
SMOOTH_THRES = {2: 24, 3: 14, 4: 2, 5: 0, 6: 0}


def use_smooth_filter(mode: int, log2s: int) -> bool:
    """True -> fG (B-spline smoothing), False -> fC (Catmull-Rom)."""
    if mode < 2 or mode > 66:
        return False
    dist = min(abs(mode - 18), abs(mode - 50))
    return dist > SMOOTH_THRES.get(log2s, 0)


def _fix_sum(row):
    row = list(row)
    row[1] += 64 - sum(row)  # centre tap absorbs the rounding residue
    return row


@lru_cache(maxsize=None)
def fc_filters() -> np.ndarray:
    """[32, 4] int32 Catmull-Rom taps at phase p/32, scaled by 64.

    64*tap_k(t), t = p/32, as exact rationals over 2048:
      f-1 = (-t^3+2t^2-t)/2, f0 = (3t^3-5t^2+2)/2,
      f1  = (-3t^3+4t^2+t)/2, f2 = (t^3-t^2)/2.
    Phase 0 is the identity {0, 64, 0, 0}."""
    out = []
    for p in range(32):
        n_m1 = 2 * (-p ** 3 + 64 * p ** 2 - 1024 * p)
        n_0 = 6 * p ** 3 - 320 * p ** 2 + 131072
        n_1 = -6 * p ** 3 + 256 * p ** 2 + 2048 * p
        n_2 = 2 * p ** 3 - 64 * p ** 2
        row = [(n + 1024) >> 11 for n in (n_m1, n_0, n_1, n_2)]
        out.append(_fix_sum(row))
    return np.asarray(out, dtype=np.int32)


@lru_cache(maxsize=None)
def fg_filters() -> np.ndarray:
    """[32, 4] int32 cubic B-spline taps at phase p/32, scaled by 64.

    64*tap_k(t) as exact rationals over 3072 (all non-negative):
      f-1 = (1-t)^3/6, f0 = (3t^3-6t^2+4)/6,
      f1  = (-3t^3+3t^2+3t+1)/6, f2 = t^3/6.
    Phase 0 smooths: {~11, ~42, ~11, 0}."""
    out = []
    for p in range(32):
        q = 32 - p
        n_m1 = q ** 3
        n_0 = 3 * p ** 3 - 192 * p ** 2 + 131072
        n_1 = -3 * p ** 3 + 96 * p ** 2 + 3072 * p + 32768
        n_2 = p ** 3
        row = [(n + 1536) // 3072 for n in (n_m1, n_0, n_1, n_2)]
        out.append(_fix_sum(row))
    return np.asarray(out, dtype=np.int32)

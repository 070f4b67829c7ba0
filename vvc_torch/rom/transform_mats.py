"""Integer transform matrices (DCT-II, DST-VII, DCT-VIII) and scan orders.

TPU-native analog of the reference's ROM tables
(`VTM/source/Lib/CommonLib/Rom.cpp` → g_trCoreDCT2P2..P64,
g_trCoreDST7P4..P32, g_trCoreDCT8P4..P32, g_scanOrder).  On TPU these are
not butterfly networks but plain dense matrices consumed by MXU matmuls
(see vvc_torch.kernels.transform).

Provenance: the reference mount was empty this session (SURVEY.md §0), so
the tables are reconstructed as follows:
  * DCT-II odd-row value sets for N=4..32 are the well-known hand-tuned
    HEVC/VVC integers (hardcoded below — high confidence).
  * The full DCT-II matrices are expanded from those value sets using the
    exact quarter-wave cosine symmetry  T[r][j] ~ S*cos(pi*r*(2j+1)/(4N)),
    which reproduces the literal reference tables for N<=32 (verified by
    unit test against hardcoded 4x4/8x8 matrices).
  * The DCT-II 64-point odd set and DST-VII 8/16/32 tables are generated by
    rounding the underlying scaled trigonometric bases.  [verify]: a few
    entries may differ by ±1 from the spec's hand-tuned literals; this
    affects conformance with foreign bitstreams only, never the
    self-consistency of this encoder/decoder pair.  Re-derive from
    the VTM reference when the mount is populated.
  * DCT-VIII is obtained from DST-VII through the exact integer identity
    DCT8[i][j] = (-1)^i * DST7[i][N-1-j]  (the reference uses the same
    relation in TrQuant_EMT.cpp).
"""
from __future__ import annotations

import math
from functools import lru_cache

import numpy as np

# Hand-tuned odd-row cosine value sets: odd_set[k] ~ round(64*sqrt(2)*cos((2k+1)*pi/(4N)))
# with a few entries adjusted by the standard for better orthogonality.
_DCT2_ODD_SETS = {
    2: [64],
    4: [83, 36],
    8: [89, 75, 50, 18],
    16: [90, 87, 80, 70, 57, 43, 25, 9],
    32: [90, 90, 88, 85, 82, 78, 73, 67, 61, 54, 46, 38, 31, 22, 13, 4],
    # 64-point (VVC extension): formula-rounded. [verify] vs spec literals.
    64: [round(64 * math.sqrt(2) * math.cos((2 * k + 1) * math.pi / 128)) for k in range(32)],
}


@lru_cache(maxsize=None)
def dct2_matrix(n: int) -> np.ndarray:
    """N×N integer DCT-II matrix, rows = basis functions (frequency order)."""
    assert n in (2, 4, 8, 16, 32, 64), n
    if n == 2:
        return np.array([[64, 64], [64, -64]], dtype=np.int32)
    half = dct2_matrix(n // 2)
    t = np.zeros((n, n), dtype=np.int32)
    # even rows: symmetric extension of the half-size matrix
    t[0::2, : n // 2] = half
    t[0::2, n // 2:] = half[:, ::-1]
    # odd rows: T[r][j] ~ S*cos(k*pi/(2N)), k = r*(2j+1); fold by the
    # period/symmetry of cos into the odd value set (k odd for odd r)
    odd = _DCT2_ODD_SETS[n]
    for r in range(1, n, 2):
        for j in range(n):
            m = (r * (2 * j + 1)) % (4 * n)
            if m > 2 * n:
                m = 4 * n - m
            if m <= n:
                t[r, j] = odd[(m - 1) // 2]
            else:
                t[r, j] = -odd[(2 * n - m - 1) // 2]
    t.setflags(write=False)
    return t


@lru_cache(maxsize=None)
def dst7_matrix(n: int) -> np.ndarray:
    """N×N integer DST-VII matrix, rows = basis functions.

    T[i][j] = round( 128*sqrt(N)/sqrt(2N+1) * sin(pi*(2i+1)*(j+1)/(2N+1)) )
    — the 64*sqrt(N)-norm convention shared by all the integer transforms
    (row norm² ≈ 4096·N); reproduces the canonical 4-point {29,55,74,84}.
    """
    assert n in (4, 8, 16, 32), n
    s = 128.0 * math.sqrt(n) / math.sqrt(2 * n + 1)
    t = np.array(
        [[round(s * math.sin(math.pi * (2 * i + 1) * (j + 1) / (2 * n + 1)))
          for j in range(n)] for i in range(n)],
        dtype=np.int32,
    )
    t.setflags(write=False)
    return t


@lru_cache(maxsize=None)
def dct8_matrix(n: int) -> np.ndarray:
    """N×N integer DCT-VIII via the exact identity from DST-VII."""
    d7 = dst7_matrix(n)
    sign = np.where(np.arange(n)[:, None] % 2 == 0, 1, -1)
    t = (sign * d7[:, ::-1]).astype(np.int32)
    t.setflags(write=False)
    return t


def transform_matrix(tr_type: int, n: int) -> np.ndarray:
    from vvc_torch.common.types import TrType

    if tr_type == TrType.DCT2:
        return dct2_matrix(n)
    if tr_type == TrType.DST7:
        return dst7_matrix(n)
    if tr_type == TrType.DCT8:
        return dct8_matrix(n)
    raise ValueError(tr_type)


# ---------------------------------------------------------------------------
# Scan orders (reference: Rom.cpp → g_scanOrder / ScanElement, initROM()).
# VVC residual coding always scans 4x4 coefficient groups (CGs) and the CGs
# themselves in reverse diagonal order ("up-right diagonal" per spec 6.5.3,
# stored forward here; residual coding walks it backward from the last
# significant position).
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def diag_scan(w: int, h: int) -> tuple:
    """Up-right diagonal scan positions [(x, y), ...] for a w×h block.

    Matches spec 6.5.3: diagonals walked from (0,0); within a diagonal from
    bottom-left to top-right (y descending? — VVC walks each anti-diagonal
    starting at the highest y).
    """
    order = []
    for d in range(w + h - 1):
        # within diagonal: y from min(d, h-1) down to ... x = d - y ascending
        y = min(d, h - 1)
        while y >= 0 and (d - y) < w:
            order.append((d - y, y))
            y -= 1
    return tuple(order)


@lru_cache(maxsize=None)
def cg_scan(log2_w: int, log2_h: int) -> tuple:
    """Scan of 4x4 coefficient groups inside a (1<<log2w)x(1<<log2h) TB."""
    w_cg = max(1, (1 << log2_w) >> 2)
    h_cg = max(1, (1 << log2_h) >> 2)
    return diag_scan(w_cg, h_cg)


# ---------------------------------------------------------------------------
# Quantization tables (reference: Quant.cpp → g_quantScales / g_invQuantScales,
# identical to HEVC's; VTM CommonLib/Quant.cpp).
# ---------------------------------------------------------------------------

QUANT_SCALES = np.array([26214, 23302, 20560, 18396, 16384, 14564], dtype=np.int32)
INV_QUANT_SCALES = np.array([40, 45, 51, 57, 64, 72], dtype=np.int32)
# rect-TB variants: blocks with odd log2W+log2H carry a residual sqrt(2)
# transform gain (the floor'ed transform shift under-divides by sqrt(2));
# compensate with x 181/256 forward / x 181/128 inverse (reference:
# Quant.cpp g_quantScales[1]/g_invQuantScales[1] lineage)
QUANT_SCALES_RECT = ((QUANT_SCALES.astype(np.int64) * 181 + 128) >> 8).astype(np.int32)
INV_QUANT_SCALES_RECT = ((INV_QUANT_SCALES.astype(np.int64) * 181 + 64) >> 7).astype(np.int32)
QUANT_SHIFT = 14
IQUANT_SHIFT = 6

"""Cross-component ALF: chroma correction filtered from co-located luma.

TPU-native analog of the reference's CC-ALF
(`VTM/source/Lib/CommonLib/AdaptiveLoopFilter.cpp` →
applyCcAlfFilter; EncoderLib/EncAdaptiveLoopFilter.cpp →
deriveCcAlfFilter; spec 8.8.5.7).  A high-pass diamond of luma samples
around each chroma position's co-located luma drives an additive chroma
correction.

Self-consistent simplifications ([verify] — SURVEY §0): 8-tap diamond with
sum-zero features (each tap reads L(p_i) − L(centre)), 1<<7 fixed-point
coefficients clipped to [−64, 63], frame-level on/off per component (the
reference adds per-CTB control and a trained coefficient codebook).  The
encoder derives by least squares on (orig − recon) chroma vs the luma
features; both halves apply the IDENTICAL integer filter, so streams stay
bit-exact.
"""
from __future__ import annotations

import numpy as np

# luma offsets (dy, dx) around the co-located sample (2y, 2x), 4:2:0
CCALF_TAPS = ((-1, 0), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1), (2, 0))
CCALF_SHIFT = 7


def _features(luma: np.ndarray, ch: int, cw: int) -> np.ndarray:
    """[T, ch, cw] int32 high-pass features: L(centre+off) − L(centre) at
    each chroma position's co-located luma (edge-clamped)."""
    lh, lw = luma.shape
    ys = np.arange(ch) * 2
    xs = np.arange(cw) * 2
    centre = luma[np.minimum(ys, lh - 1)[:, None],
                  np.minimum(xs, lw - 1)[None, :]].astype(np.int32)
    out = np.empty((len(CCALF_TAPS), ch, cw), dtype=np.int32)
    for t, (dy, dx) in enumerate(CCALF_TAPS):
        yy = np.clip(ys + dy, 0, lh - 1)
        xx = np.clip(xs + dx, 0, lw - 1)
        out[t] = luma[yy[:, None], xx[None, :]].astype(np.int32) - centre
    return out


def derive_ccalf(orig_c: np.ndarray, recon_c: np.ndarray,
                 luma: np.ndarray, bit_depth: int):
    """LS-fit integer coefficients for one chroma plane, or None when the
    filter does not reduce SSE (reference: deriveCcAlfFilterCoeff +
    the enable decision)."""
    ch, cw = recon_c.shape
    f = _features(luma, ch, cw).reshape(len(CCALF_TAPS), -1).astype(np.float64)
    tgt = (orig_c.astype(np.float64) - recon_c).reshape(-1)
    A = f @ f.T + 1e-3 * np.eye(len(CCALF_TAPS))
    b = f @ tgt
    c = np.linalg.solve(A, b)
    ci = np.clip(np.round(c * (1 << CCALF_SHIFT)), -64, 63).astype(np.int32)
    if not ci.any():
        return None
    corr = apply_ccalf_delta(recon_c, luma, ci, bit_depth)
    sse0 = ((orig_c.astype(np.int64) - recon_c) ** 2).sum()
    sse1 = ((orig_c.astype(np.int64) - corr) ** 2).sum()
    return ci if sse1 < sse0 else None


def apply_ccalf_delta(recon_c: np.ndarray, luma: np.ndarray,
                      coeffs: np.ndarray, bit_depth: int) -> np.ndarray:
    """recon_c + clip(round(Σ c_t·feature_t)) — the normative application
    (both codec halves)."""
    ch, cw = recon_c.shape
    f = _features(luma, ch, cw).astype(np.int64)
    acc = np.tensordot(coeffs.astype(np.int64), f, axes=(0, 0))
    corr = (acc + (1 << (CCALF_SHIFT - 1))) >> CCALF_SHIFT
    lim = 1 << (bit_depth - 1)
    corr = np.clip(corr, -lim, lim - 1)
    return np.clip(recon_c + corr, 0, (1 << bit_depth) - 1).astype(np.int32)

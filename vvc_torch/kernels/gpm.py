"""Geometric partitioning mode (GPM): angled-line two-part merge blending.

TPU-native analog of the reference's geo merge mode
(`VTM/source/Lib/CommonLib/InterPrediction.cpp` →
weightedGeoBlk / motionCompensationGeo; mask derivation in
`CommonLib/Rom.cpp` g_geoParams / g_globalGeoWeights; encoder search in
`EncoderLib/EncCu.cpp` → xCheckRDCostMergeGeo).

Design notes (tpu-first, self-consistent):
- The reference ships trained 64-entry (angle, distance) tables and
  pre-rasterized weight ROMs.  Those tables are not copyable, so the mask
  here is *analytically* parameterized: 16 angles × 4 distances = 64
  modes, angle a → θ = a·π/8 with Q6 integer cos/sin, distance d shifting
  the line by d·min(w,h)/8 samples along the normal.  Integer-only
  arithmetic keeps both codec halves bit-identical; the soft ramp matches
  the spec's 8-sample 3-bit blend (weights 0..8, (p0·w + p1·(8−w) + 4)>>3).
- Masks are shape×mode static → lru_cached numpy constants; the batched
  encoder search treats them as a (modes, h, w) tensor contraction, which
  is exactly the MXU-friendly formulation (blend = mask ⊙ p0 + (8−mask) ⊙
  p1 over a candidate batch).
"""
from __future__ import annotations

import functools

import numpy as np

# Q6 integer cosine table for θ = a·π/8, a ∈ [0, 16)
_COS = tuple(int(round(64 * np.cos(a * np.pi / 8))) for a in range(16))
_SIN = tuple(int(round(64 * np.sin(a * np.pi / 8))) for a in range(16))

GPM_NUM_MODES = 64


def gpm_params(mode: int) -> tuple[int, int]:
    """mode (0..63) → (angle_idx 0..15, distance_idx 0..3)."""
    return mode >> 2, mode & 3


@functools.lru_cache(maxsize=None)
def gpm_mask(w: int, h: int, mode: int) -> np.ndarray:
    """Part-0 blend weights (h, w) int32 in 0..8.

    Sample (x, y) weight = clip(0, 8, ramp(signed distance to the line)),
    line through the block centre shifted by d·min(w,h)/8 samples along
    the unit normal (cos θ, sin θ).  Coordinates are doubled to stay
    integer about the half-sample centre; one luma sample = 128 units
    after the Q6 trig scale, so the >>7 ramp steps one weight per sample
    (8-sample transition band, as in the spec's g_globalGeoWeights)."""
    a, d = gpm_params(mode)
    c, s = _COS[a], _SIN[a]
    xs = 2 * np.arange(w, dtype=np.int64) + 1 - w
    ys = 2 * np.arange(h, dtype=np.int64) + 1 - h
    t = xs[None, :] * c + ys[:, None] * s          # Q6 half-sample units
    rho = d * (min(w, h) * 128) // 8               # d·min/8 samples
    wgt = ((t - rho + 64) >> 7) + 4
    return np.clip(wgt, 0, 8).astype(np.int32)


def gpm_mask_chroma(cw: int, ch: int, mode: int) -> np.ndarray:
    """4:2:0 chroma mask = luma mask subsampled at even phases
    (reference: weightedGeoBlk chroma stride-2 read)."""
    return gpm_mask(cw * 2, ch * 2, mode)[::2, ::2]


def gpm_blend(p0: np.ndarray, p1: np.ndarray, wgt: np.ndarray) -> np.ndarray:
    """3-bit soft blend: (p0·w + p1·(8−w) + 4) >> 3."""
    return ((p0.astype(np.int64) * wgt + p1.astype(np.int64) * (8 - wgt)
             + 4) >> 3).astype(np.int32)


def gpm_uni_candidates(cands):
    """Uni-prediction GPM candidate list from the regular merge list.

    Candidate m uses list (m & 1) when that list is present, else the
    other — the spec 8.5.7 parity rule (reference:
    PU::getGeoMergeCandidates).  Returns [(list, (mvx, mvy), ref_idx)]."""
    out = []
    for m, (d, mv, ref) in enumerate(cands):
        l = m & 1
        if not (d >> l) & 1:
            l ^= 1
        if not (d >> l) & 1:
            out.append(None)        # keeps index alignment with the merge
            continue                # list; never selected by the encoder
        out.append((l, (int(mv[l][0]), int(mv[l][1])), int(ref[l])))
    return out

"""Sample Adaptive Offset (SAO) — classification and application.

TPU-native analog of the reference's SAO
(`VTM/source/Lib/CommonLib/SampleAdaptiveOffset.cpp` →
SAOProcess / offsetBlock; OpenVVC libovvc/rcn_sao.c).  SURVEY.md §2.2:
"elementwise classify+add" — edge-offset classification is two shifted
compares and a LUT add, fully vectorized over each CTU region (numpy).

Per-CTU parameters (vvc_torch.model.frame.SaoParams): mode OFF/BO/EO, EO class
(0°,90°,135°,45°), band position, and 4 offsets.  Classification reads the
*pre-SAO* (deblocked) picture — callers pass a snapshot `src` and mutate
`dst`.  Samples whose EO neighbour falls outside the picture (or across a
tile edge, since loop-filter-across-tiles is off) are left unfiltered.
"""
from __future__ import annotations

import dataclasses

import numpy as np

SAO_OFF, SAO_BO, SAO_EO = 0, 1, 2
# EO direction (dx, dy) per class: 0°, 90°, 135°, 45°
EO_DIRS = ((1, 0), (0, 1), (1, 1), (1, -1))
MAX_SAO_OFFSET = 7  # 8-bit (spec: (1 << min(bd,10)-5) - 1)


@dataclasses.dataclass
class SaoParams:
    """One component's SAO parameters for one CTU."""

    mode: int = SAO_OFF
    eo_class: int = 0
    band_pos: int = 0
    offsets: tuple = (0, 0, 0, 0)


def eo_categories(src: np.ndarray, x0: int, y0: int, w: int, h: int,
                  eo_class: int, lim_x0: int, lim_x1: int,
                  lim_y0: int = 0, lim_y1: int | None = None) -> np.ndarray:
    """Category map (0..4) for a CTU region of the pre-SAO plane.

    lim_*: tile bounds — neighbours outside are unavailable (the
    loop_filter_across_tiles=0 semantics on BOTH axes; ADVICE r3 #2).
    """
    ph, pw = src.shape
    if lim_y1 is None:
        lim_y1 = ph
    dx, dy = EO_DIRS[eo_class]
    ys, xs = np.mgrid[y0:y0 + h, x0:x0 + w]
    ax, ay = xs - dx, ys - dy
    bx, by = xs + dx, ys + dy
    valid = ((ax >= lim_x0) & (ax < lim_x1) & (ay >= lim_y0) & (ay < lim_y1)
             & (bx >= lim_x0) & (bx < lim_x1) & (by >= lim_y0)
             & (by < lim_y1))
    axc, ayc = np.clip(ax, 0, pw - 1), np.clip(ay, 0, ph - 1)
    bxc, byc = np.clip(bx, 0, pw - 1), np.clip(by, 0, ph - 1)
    c = src[y0:y0 + h, x0:x0 + w]
    sa = np.sign(c - src[ayc, axc])
    sb = np.sign(c - src[byc, bxc])
    t = sa + sb
    cat = np.zeros_like(c)
    cat[(t == -2)] = 1
    cat[(t == -1)] = 2
    cat[(t == 1)] = 3
    cat[(t == 2)] = 4
    cat[~valid] = 0
    return cat


def eo_categories_region(src: np.ndarray, x0: int, x1: int,
                         eo_class: int, y0: int = 0,
                         y1: int | None = None) -> np.ndarray:
    """Category map for the plane rectangle [y0:y1, x0:x1) with neighbours
    limited to the region (tile) — pure slicing, no index gathers.  Equal
    to assembling per-CTU eo_categories over the region (encoder stats
    fast path)."""
    if y1 is None:
        y1 = src.shape[0]
    dx, dy = EO_DIRS[eo_class]
    c = src[y0:y1, x0:x1].astype(np.int32)
    h, w = c.shape
    p = np.pad(c, 1, mode="edge")
    na = p[1 - dy:1 - dy + h, 1 - dx:1 - dx + w]
    nb = p[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
    t = np.sign(c - na) + np.sign(c - nb)
    cat = np.zeros((h, w), dtype=np.int8)
    cat[t == -2] = 1
    cat[t == -1] = 2
    cat[t == 1] = 3
    cat[t == 2] = 4
    if dx:
        cat[:, 0] = 0
        cat[:, -1] = 0
    if dy:
        cat[0] = 0
        cat[-1] = 0
    return cat


def apply_sao_region(dst: np.ndarray, src: np.ndarray, params: SaoParams,
                     x0: int, y0: int, w: int, h: int, bit_depth: int,
                     lim_x0: int, lim_x1: int, lim_y0: int = 0,
                     lim_y1: int | None = None):
    """Apply one CTU's SAO in place on dst (classify from src)."""
    if params.mode == SAO_OFF:
        return
    maxv = (1 << bit_depth) - 1
    region = src[y0:y0 + h, x0:x0 + w]
    if params.mode == SAO_BO:
        band = region >> (bit_depth - 5)
        off = np.zeros_like(region)
        for k in range(4):
            off[band == ((params.band_pos + k) & 31)] = params.offsets[k]
    else:
        cat = eo_categories(src, x0, y0, w, h, params.eo_class, lim_x0,
                            lim_x1, lim_y0, lim_y1)
        lut = np.array([0] + list(params.offsets), dtype=np.int32)
        off = lut[cat]
    dst[y0:y0 + h, x0:x0 + w] = np.clip(region + off, 0, maxv)


def sao_filter_plane(plane: np.ndarray, ctu_params: dict, ctu_size: int,
                     bit_depth: int, tile_bounds, comp_scale: int = 0):
    """Apply per-CTU SAO over a whole plane in place.

    ctu_params: {(ctu_x, ctu_y) luma coords: SaoParams}.  comp_scale=1 for
    chroma (halved geometry).  tile_bounds: [(tx0, tx1, ty0, ty1), ...]
    luma coords (2-tuples = full-height columns, back-compat).
    """
    src = plane.copy()
    h, w = plane.shape
    cs = ctu_size >> comp_scale
    for (cx, cy), p in ctu_params.items():
        x0, y0 = cx >> comp_scale, cy >> comp_scale
        if x0 >= w or y0 >= h:
            continue
        rw, rh = min(cs, w - x0), min(cs, h - y0)
        lim = (0, w, 0, h)
        for tb in tile_bounds:
            tx0, tx1 = tb[0], tb[1]
            ty0, ty1 = (tb[2], tb[3]) if len(tb) == 4 else (0, h << comp_scale)
            t0, t1 = tx0 >> comp_scale, tx1 >> comp_scale
            r0, r1 = ty0 >> comp_scale, ty1 >> comp_scale
            if t0 <= x0 < t1 and r0 <= y0 < r1:
                lim = (t0, min(t1, w), r0, min(r1, h))
                break
        apply_sao_region(plane, src, p, x0, y0, rw, rh, bit_depth, *lim)

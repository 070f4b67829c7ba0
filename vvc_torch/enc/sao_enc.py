"""SAO encoder decisions: per-CTU statistics → RD-chosen parameters.

TPU-native analog of the reference's SAO encoder
(`VTM/source/Lib/EncoderLib/EncSampleAdaptiveOffset.cpp` →
getStatistics / decidePicParams / decideBlkParams).  Classic derivation:
for each candidate type, per-category (diff-sum d, count n) statistics
give the optimal offset o* ≈ d/n and the distortion change
ΔSSE(o) = n·o² − 2·o·d; choose min over {OFF, BO windows, 4 EO classes}
with λ·rate.

Statistics are gathered picture-at-once (whole-plane classification +
blocked reductions — the device-friendly shape; reference iterates CTUs);
only the final per-CTU arg-min runs as a small host loop.  Merge-left/up
RD is a later stage [verify].

Port of vvc/enc/sao_enc.py: the statistics run on `device` through
vvc_torch.kernels.sao.sao_stats_dev (csrc/sao_stats.cu on CUDA) and come
back as float64, as vvc's do; the decision is vvc's host code, copied.
"""
from __future__ import annotations

import numpy as np

import torch

from vvc_torch.kernels.sao import (SaoParams, SAO_BO, SAO_EO,
                                   MAX_SAO_OFFSET, sao_stats_dev)
from vvc_torch.enc.rdo import rd_lambda
from vvc_torch.ops import resolve_device


def _best_offsets_arr(d: np.ndarray, n: np.ndarray, sign: int, lam: float):
    """Vectorized optimal clipped offsets + RD costs.  d, n same shape."""
    with np.errstate(divide="ignore", invalid="ignore"):
        o = np.where(n > 0, np.round(d / np.maximum(n, 1)), 0.0)
    if sign > 0:
        o = np.clip(o, 0, MAX_SAO_OFFSET)
    elif sign < 0:
        o = np.clip(o, -MAX_SAO_OFFSET, 0)
    else:
        o = np.clip(o, -MAX_SAO_OFFSET, MAX_SAO_OFFSET)
    best_o = np.zeros_like(o)
    best_c = np.zeros_like(d, dtype=np.float64)
    for cand in (o, np.trunc(o / 2)):
        c = n * cand * cand - 2 * cand * d + lam * (np.abs(cand) + 1)
        better = c < best_c
        best_o = np.where(better, cand, best_o)
        best_c = np.where(better, c, best_c)
    return best_o.astype(np.int64), best_c


_VALID_CACHE: dict = {}


def _valid_vectors(h: int, w: int, tiles_c):
    """validx [w], validy [h] bool — False at region-boundary cols/rows
    (EO classes whose neighbour would cross a tile/picture edge classify
    those positions as category 0)."""
    key = (h, w, tuple(tuple(tb) for tb in tiles_c))
    ent = _VALID_CACHE.get(key)
    if ent is not None:
        return ent
    vx = np.ones(w, bool)
    vy = np.ones(h, bool)
    for tb in tiles_c:
        t0, t1 = tb[0], min(tb[1], w)
        r0, r1 = (tb[2], min(tb[3], h)) if len(tb) == 4 else (0, h)
        vx[t0] = False
        vx[t1 - 1] = False
        vy[r0] = False
        vy[r1 - 1] = False
    _VALID_CACHE[key] = (vx, vy)
    if len(_VALID_CACHE) > 8:
        _VALID_CACHE.pop(next(iter(_VALID_CACHE)))
    return vx, vy


def _component_stats(orig: np.ndarray, rec: np.ndarray, cs: int,
                     bit_depth: int, tiles_c, device):
    """Per-CTU stats for one component: EO (d,n)[4class][4cat][ny,nx] and
    BO (d,n)[32band][ny,nx] — gathered on `device` (one `sao_stats`
    launch on CUDA) and copied back as float64."""
    h, w = orig.shape
    ny, nx = -(-h // cs), -(-w // cs)
    vx, vy = _valid_vectors(h, w, tiles_c)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    stats = sao_stats_dev(dev(orig.astype(np.int32, copy=False)),
                          dev(rec.astype(np.int32, copy=False)), dev(vx),
                          dev(vy), cs, bit_depth)
    return tuple(s.cpu().numpy().astype(np.float64) for s in stats) + (ny,
                                                                        nx)


def _decide_component(orig, rec, cs, qp, bit_depth, tiles_c, device):
    lam = rd_lambda(qp)
    eo_d, eo_n, bo_d, bo_n, ny, nx = _component_stats(orig, rec, cs,
                                                      bit_depth, tiles_c,
                                                      device)
    # EO: per class, per cat offsets/costs (sign-constrained cats)
    eo_off = np.zeros((4, 4, ny, nx), dtype=np.int64)
    eo_cost = np.full((4, ny, nx), 3.0 * lam)
    for ec in range(4):
        for k, sign in ((0, 1), (1, 1), (2, -1), (3, -1)):
            o, c = _best_offsets_arr(eo_d[ec, k], eo_n[ec, k], sign, lam)
            eo_off[ec, k] = o
            eo_cost[ec] += c
    # BO: per-band offsets, then best 4-band window
    bo_off, bo_cost = _best_offsets_arr(bo_d, bo_n, 0, lam)  # [ny,nx,32]
    win_cost = np.full((29, ny, nx), 8.0 * lam)
    for s0 in range(29):
        win_cost[s0] += bo_cost[:, :, s0:s0 + 4].sum(axis=2)
    best_win = np.argmin(win_cost, axis=0)                   # [ny,nx]
    best_bo = np.take_along_axis(win_cost, best_win[None], axis=0)[0]
    best_eo = np.argmin(eo_cost, axis=0)                     # [ny,nx]
    best_eo_cost = np.min(eo_cost, axis=0)

    out = {}
    for j in range(ny):
        for i in range(nx):
            cands = [(0.0, SaoParams())]
            ec = int(best_eo[j, i])
            offs = eo_off[ec, :, j, i]
            cands.append((float(best_eo_cost[j, i]),
                          SaoParams(SAO_EO, ec, 0, tuple(int(v) for v in offs))))
            s0 = int(best_win[j, i])
            cands.append((float(best_bo[j, i]),
                          SaoParams(SAO_BO, 0, s0,
                                    tuple(int(v) for v in bo_off[j, i, s0:s0 + 4]))))
            out[(i, j)] = min(cands, key=lambda t: t[0])[1]
    return out


def decide_sao_frame(orig_planes, recon_planes, qp: int, bit_depth: int,
                     ctu_size: int, tiles, device=None) -> dict:
    """Per-CTU SAO params for all components:
    {(ctu_x, ctu_y) luma coords: (SaoParams_y, SaoParams_cb, SaoParams_cr)}.
    device: where the statistics run (None = CUDA, raising without it).

    Each component signals complete params ([verify]: the reference shares
    chroma type between cb/cr)."""
    device = resolve_device(device)
    h, w = orig_planes[0].shape
    tiles4 = [(tb[0], tb[1], tb[2], tb[3]) if len(tb) == 4
              else (tb[0], tb[1], 0, h) for tb in tiles]
    tiles_l = [(x0, min(x1, w), y0, min(y1, h))
               for x0, x1, y0, y1 in tiles4]
    tiles_c = [(x0 >> 1, min(x1 >> 1, w >> 1), y0 >> 1,
                min(y1 >> 1, h >> 1)) for x0, x1, y0, y1 in tiles4]
    per_comp = [
        _decide_component(orig_planes[0], recon_planes[0], ctu_size, qp,
                          bit_depth, tiles_l, device),
        _decide_component(orig_planes[1], recon_planes[1], ctu_size >> 1, qp,
                          bit_depth, tiles_c, device),
        _decide_component(orig_planes[2], recon_planes[2], ctu_size >> 1, qp,
                          bit_depth, tiles_c, device),
    ]
    out = {}
    for (i, j), py in per_comp[0].items():
        key = (i * ctu_size, j * ctu_size)
        out[key] = (py, per_comp[1].get((i, j), SaoParams()),
                    per_comp[2].get((i, j), SaoParams()))
    return out

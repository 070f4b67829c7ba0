"""Wavefront (anti-diagonal batched) reconstruction — the decoder's device
path.

Port of vvc/dec/wavefront.py.  `compute_waves` is copied unchanged: leaves
are layered by exact dependency depth (leaf B waits only for the
earlier-z-order leaves that own samples on B's reference border), and every
leaf of a wave is then reconstructed in one batched pass per (size,
component).  vvc mixes host numpy (the per-leaf reference lines, MIP and
CCLM) with jitted programs; here the planes go to the device once per
`reconstruct_leaves_wavefront` call and come back once, and everything in
between runs there:

  * `wave_ref_lines` (csrc/ref_lines.cu): each leaf's 4S+3 line from the
    plane reconstructed so far, available iff its 4×4 unit's order-map
    entry is below the leaf's z-order index;
  * `intra_pred_one` for the leaf's own mode (equal, at every size 4..64,
    to vvc's pick from all 67 modes: tests/test_torch_dec.py), then
    `mip_pred_all` and a pick for the MIP leaves (luma);
  * `wave_cclm` (csrc/cclm.cu) for the CCLM chroma leaves, on `luma_ds`
    of the luma plane as it stands after the wave's luma;
  * lossy: `dequant` (csrc/quant_rate.cu), `lfnst_inv`, `transform_inv`
    per MTS type; lossless: the levels are the residual;
  * `wave_commit` (csrc/wavefront.cu): pred + resi (the BDPCM inverse for
    lossless luma), clip, scatter into the plane, zi into the order map.

A group's leaves are reordered by (MTS type, LFNST index) on the host so
that each transform and LFNST launch takes a contiguous slice; the leaves
of one wave are independent, so the order does not change the result.
Each group's leaf data (positions, modes, levels) is packed on the host and
uploaded with the rest of the call's groups in one copy.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from vvc_torch import ops
from vvc_torch.kernels.cclm import luma_ds_plane_dev, predict_cclm_wave
from vvc_torch.kernels.intra import build_ref_lines_wave, predict_modes_batch
from vvc_torch.kernels.lfnst import inv_lfnst_batch
from vvc_torch.kernels.mip import mip_predict_all_batch
from vvc_torch.kernels.quant import dequant_batch
from vvc_torch.kernels.transform import MTS_TR, inv_transform_batch
from vvc_torch.model.recon import chroma_qp

# rows of a group's packed metadata ([_NMETA, N] int32, each row
# contiguous); the MIP rows hold, for the group's first M slots, the MIP
# leaves' positions in the group and their MIP modes
_X, _Y, _ZI, _MODE, _CMODE, _BDPCM, _MIPI, _MIPK = range(8)
_NMETA = 8


def compute_waves(leaves, width: int, height: int):
    """Exact dependency layering.  Returns list of index lists."""
    w4, h4 = (width + 3) >> 2, (height + 3) >> 2
    level_map = np.full((h4, w4), -1, dtype=np.int32)
    levels = np.empty(len(leaves), dtype=np.int32)
    for i, leaf in enumerate(leaves):
        x0, y0, s = leaf.x0, leaf.y0, leaf.size
        lv = -1
        # top border row y0-1, cols x0-1 .. x0+2s-1
        if y0 > 0:
            r = (y0 - 1) >> 2
            c0 = max(0, (x0 - 1) >> 2)
            c1 = min(w4 - 1, (x0 + 2 * s - 1) >> 2)
            lv = max(lv, int(level_map[r, c0:c1 + 1].max(initial=-1)))
        # left border col x0-1, rows y0 .. y0+2s-1
        if x0 > 0:
            c = (x0 - 1) >> 2
            r0 = y0 >> 2
            r1 = min(h4 - 1, (y0 + 2 * s - 1) >> 2)
            lv = max(lv, int(level_map[r0:r1 + 1, c].max(initial=-1)))
        levels[i] = lv + 1
        s4 = s >> 2
        level_map[y0 >> 2:(y0 >> 2) + s4, x0 >> 2:(x0 >> 2) + s4] = lv + 1
    waves = [[] for _ in range(int(levels.max(initial=0)) + 1)]
    for i, lv in enumerate(levels):
        waves[lv].append(i)
    return waves


class _Group:
    """Host side of one (wave, size, component) group: its leaves in
    launch order, the packed int32 words ([_NMETA, N] metadata, then the
    [N, S, S] levels) and the slices each launch takes."""

    def __init__(self, group, comp: int, lossless: bool, cclm: bool):
        size = group[0][1]
        n = len(group)
        lfn = [g[0].lfnst if comp == 0 and not lossless else 0
               for g in group]
        order = sorted(range(n), key=lambda k: (group[k][5], lfn[k]))
        self.size, self.n = size, n
        meta = np.zeros((_NMETA, n), dtype=np.int32)
        levs = np.zeros((n, size, size), dtype=np.int32)
        self.has_lev = np.zeros(n, dtype=bool)
        mts = np.empty(n, dtype=np.int32)
        lfnst = np.empty(n, dtype=np.int32)
        for j, k in enumerate(order):
            leaf, s, x0, y0, lv, mt, zi = group[k]
            mode = leaf.luma_mode
            if comp != 0 and mode >= 67:
                mode = 0             # chroma DM of a MIP leaf maps to planar
            meta[_X, j], meta[_Y, j], meta[_ZI, j] = x0, y0, zi
            meta[_MODE, j] = mode
            meta[_CMODE, j] = leaf.chroma_mode if cclm else 0
            meta[_BDPCM, j] = (getattr(leaf, "bdpcm", 0)
                               if lossless and comp == 0 else 0)
            mts[j], lfnst[j] = mt, lfn[k]
            if lv is not None:
                levs[j] = lv
                self.has_lev[j] = True
        self.mip = [j for j in range(n) if comp == 0 and meta[_MODE, j] >= 67]
        meta[_MIPI, :len(self.mip)] = self.mip
        meta[_MIPK, :len(self.mip)] = meta[_MODE, self.mip] - 67
        self.cclm = bool(np.any(meta[_CMODE]))
        self.lossless = lossless
        self.mts_runs = _runs(mts)
        self.lfnst_runs = [r for r in _runs(lfnst) if r[0]]
        self.words = np.concatenate([meta.reshape(-1), levs.reshape(-1)])


def _runs(v: np.ndarray):
    """[(value, start, end)] of the runs of equal values in v."""
    cut = np.flatnonzero(np.diff(v)) + 1
    starts = np.concatenate([[0], cut])
    ends = np.concatenate([cut, [len(v)]])
    return [(int(v[a]), int(a), int(b)) for a, b in zip(starts, ends)]


def _recon_group(plane, order_map, g: _Group, words: torch.Tensor, qp: int,
                 bit_depth: int, cclm_ds=None):
    """Reconstruct one packed group on plane's device; mutates plane and
    order_map."""
    n, s = g.n, g.size
    meta = words[:_NMETA * n].view(_NMETA, n)
    levs = words[_NMETA * n:].view(n, s, s)
    xs, ys, zis = meta[_X], meta[_Y], meta[_ZI]
    refs = build_ref_lines_wave(plane, order_map, xs, ys, zis, s, bit_depth)
    pred = predict_modes_batch(refs, meta[_MODE], s, bit_depth)
    if g.mip:
        m = len(g.mip)
        idx = meta[_MIPI, :m].long()
        allm = mip_predict_all_batch(refs.index_select(0, idx), s, bit_depth)
        picked = allm[torch.arange(m, device=allm.device),
                      meta[_MIPK, :m].long()]
        pred.index_copy_(0, idx, picked)
    if g.cclm and cclm_ds is not None:
        predict_cclm_wave(cclm_ds, plane, order_map, xs, ys, zis,
                          meta[_CMODE], s, bit_depth, pred)
    if g.lossless:
        resi = levs
    else:
        resi = torch.zeros_like(pred)
        if g.has_lev.any():
            deq = dequant_batch(levs, qp, bit_depth)
            for idx_l, a, b in g.lfnst_runs:
                if g.has_lev[a:b].any():
                    deq[a:b] = inv_lfnst_batch(deq[a:b].contiguous(),
                                               meta[_MODE, a:b], idx_l)
            for mt, a, b in g.mts_runs:
                if not g.has_lev[a:b].any():
                    continue
                th, tv = MTS_TR[mt]
                out = inv_transform_batch(deq[a:b].contiguous(), bit_depth,
                                          int(th), int(tv))
                if a == 0 and b == n:
                    resi = out
                else:
                    resi[a:b] = out
    commit_wave(plane, order_map, pred, resi, xs, ys, zis, meta[_BDPCM],
                bit_depth)


def _recon_wave_group(plane, order_map, group, qp, bit_depth, lossless, comp,
                      cclm_ds=None):
    """Batched reconstruction of same-size leaves of one wave for one
    component (port of vvc/dec/wavefront.py:65): plane [H,W] and order_map
    [⌈H/4⌉,⌈W/4⌉] are int32 tensors on one device, mutated in place;
    group holds (leaf, size, x0, y0, levels, mts, zi) tuples as vvc's;
    cclm_ds is the downsampled luma [H,W] of a chroma pass, or None.

    order_map holds the z-order index of each reconstructed 4×4 unit (a
    large sentinel when pending): a reference unit is available iff it was
    reconstructed AND precedes this leaf in z-order — exactly the
    sequential decoder's availability, even though waves reorder work."""
    g = _Group(group, comp, lossless, cclm_ds is not None)
    words = torch.from_numpy(g.words).to(plane.device)
    _recon_group(plane, order_map, g, words, qp, bit_depth, cclm_ds)


def reconstruct_leaves_wavefront(leaves, recon_planes, qp: int,
                                 bit_depth: int = 8, lossless: bool = False,
                                 device=None):
    """Decode-mode reconstruction, batched per dependency wave, on
    `device` (None: CUDA, raising where it is absent; "cpu": the kernels'
    plain twins).

    Bit-exact with vvc.dec.wavefront.reconstruct_leaves_wavefront.  The
    numpy recon_planes are uploaded whole, and only the rectangle the
    leaves cover is written back (tiles of one picture share the planes).
    Returns the number of waves (for instrumentation)."""
    dev = ops.resolve_device(device)
    y_pl, cb_pl, cr_pl = recon_planes
    h, w = y_pl.shape
    waves = compute_waves(leaves, w, h)
    if not leaves:
        return len(waves)
    qpc = chroma_qp(qp)
    # host: every group of every wave, packed in launch order
    plan = []
    for wave in waves:
        by_size_y = {}
        by_size_c = {}
        for i in wave:
            lf = leaves[i]
            by_size_y.setdefault(lf.size, []).append(
                (lf, lf.size, lf.x0, lf.y0, lf.lev_y, lf.mts, i))
            by_size_c.setdefault(lf.size >> 1, []).append((lf, i))
        cclm = any(leaves[i].chroma_mode for i in wave)
        steps = [(0, _Group(grp, 0, lossless, False))
                 for grp in by_size_y.values()]
        for s, lfs in by_size_c.items():
            for comp, attr in ((1, "lev_cb"), (2, "lev_cr")):
                grp = [(lf, s, lf.x0 >> 1, lf.y0 >> 1, getattr(lf, attr), 0,
                        i) for lf, i in lfs]
                steps.append((comp, _Group(grp, comp, lossless, cclm)))
        plan.append((cclm, steps))
    groups = [g for _, steps in plan for _, g in steps]
    offs = np.cumsum([0] + [g.words.size for g in groups])
    words = torch.from_numpy(np.concatenate([g.words for g in groups])).to(
        dev)
    planes = [torch.from_numpy(np.ascontiguousarray(p, dtype=np.int32)).to(
        dev, copy=True) for p in recon_planes]
    big = np.iinfo(np.int32).max
    orders = [torch.full(((hh + 3) >> 2, (ww + 3) >> 2), big,
                         dtype=torch.int32, device=dev)
              for hh, ww in (p.shape for p in recon_planes)]
    k = 0
    for cclm, steps in plan:
        ds = None
        for comp, g in steps:
            if comp == 1 and cclm and ds is None:
                ds = luma_ds_plane_dev(planes[0])
            _recon_group(planes[comp], orders[comp], g,
                         words[offs[k]:offs[k + 1]],
                         qp if comp == 0 else qpc, bit_depth,
                         ds if comp else None)
            k += 1
    # write back the rectangle the leaves cover, in each plane
    x0 = min(lf.x0 for lf in leaves)
    y0 = min(lf.y0 for lf in leaves)
    x1 = max(lf.x0 + lf.size for lf in leaves)
    y1 = max(lf.y0 + lf.size for lf in leaves)
    for c, (p, t) in enumerate(zip(recon_planes, planes)):
        sh = 0 if c == 0 else 1
        p[y0 >> sh:y1 >> sh, x0 >> sh:x1 >> sh] = \
            t[y0 >> sh:y1 >> sh, x0 >> sh:x1 >> sh].cpu().numpy()
    return len(waves)


# ---------------------------------------------------------------------------
# wave_commit: pred + resi → plane, zi → order map
# ---------------------------------------------------------------------------


def commit_wave_plain(plane, order_map, pred, resi, xs, ys, zis, bdpcm,
                      bit_depth: int):
    """Plain twin of the `wave_commit` kernel (in place)."""
    n, s, _ = pred.shape
    dev = plane.device
    r = resi.to(torch.int32)
    if bool((bdpcm != 0).any()):
        b = bdpcm.long()[:, None, None]
        r = torch.where(b == 1, r.long().cumsum(2).to(torch.int32),
                        torch.where(b == 2, r.long().cumsum(1).to(
                            torch.int32), r))
    rec = (pred.to(torch.int32) + r).clamp(0, (1 << bit_depth) - 1)
    ar = torch.arange(s, device=dev)
    yy = ys.long()[:, None, None] + ar[None, :, None]
    xx = xs.long()[:, None, None] + ar[None, None, :]
    plane[yy, xx] = rec.to(plane.dtype)
    s4 = max(1, s >> 2)
    a4 = torch.arange(s4, device=dev)
    oy = (ys.long() >> 2)[:, None, None] + a4[None, :, None]
    ox = (xs.long() >> 2)[:, None, None] + a4[None, None, :]
    order_map[oy, ox] = zis.to(order_map.dtype)[:, None, None].expand(
        n, s4, s4)
    return plane


def _commit_cuda(plane, order_map, pred, resi, xs, ys, zis, bdpcm,
                 bit_depth: int):
    ops.check_cuda_i32("wave_commit", plane, order_map, pred, resi, xs, ys,
                       zis, bdpcm)
    h, w = plane.shape
    n, s, _ = pred.shape
    if order_map.shape != ((h + 3) >> 2, (w + 3) >> 2):
        raise ValueError("wave_commit: order map does not cover the plane")
    if resi.shape != pred.shape or any(t.shape != (n,)
                                       for t in (xs, ys, zis, bdpcm)):
        raise ValueError("wave_commit: bad residuals or leaves")
    if n == 0:
        return plane
    fn = ops.lib("wave_commit").wave_commit_launch
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 6
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    err = fn(plane.data_ptr(), h, w, order_map.data_ptr(), order_map.shape[1],
             pred.data_ptr(), resi.data_ptr(), xs.data_ptr(), ys.data_ptr(),
             zis.data_ptr(), bdpcm.data_ptr(), n, s, bit_depth,
             ops.stream_ptr(plane))
    ops.launched("wave_commit", err)
    return plane


def commit_wave(plane: torch.Tensor, order_map: torch.Tensor,
                pred: torch.Tensor, resi: torch.Tensor, xs: torch.Tensor,
                ys: torch.Tensor, zis: torch.Tensor, bdpcm: torch.Tensor,
                bit_depth: int) -> torch.Tensor:
    """Commit N S×S leaves (x0, y0, zi) of one wave: rec = clip(pred +
    resi, 0, 2^bd − 1), with the BDPCM inverse (a prefix sum of resi along
    rows, bdpcm 1, or columns, bdpcm 2) where bdpcm is not 0, scattered
    into plane; zi written into the leaves' units of order_map.  In place.
    Replaces vvc/dec/wavefront.py:111-114 and :134-138.  CUDA tensor →
    csrc/wavefront.cu `wave_commit`; CPU tensor or `ops.plain()` → the
    twin."""
    if ops.use_kernel(plane):
        return _commit_cuda(plane, order_map, pred, resi, xs, ys, zis, bdpcm,
                            bit_depth)
    return commit_wave_plain(plane, order_map, pred, resi, xs, ys, zis, bdpcm,
                             bit_depth)

"""Native sequential reconstruction wrapper — mirror of
vvc_torch.model.recon.reconstruct_leaves backed by the recon core
(vvc_torch/packer/recon_core.cpp, built by vvc_torch.packer.recon_lib).

Copy of vvc/packer/native_recon.py (the full-tool `recon_leaves_v2` pass
only; the older per-leaf entry points are not used by the port).  One
`recon_leaves_v2` call per (tile, component) — luma and chroma dependency
chains are independent, so all-luma-then-all-chroma is equivalent to the
interleaved z-order and removes per-block ctypes round trips.  Planes and
availability maps are numpy buffers mutated in place by the C++ core.
Bit-exact equality with the numpy oracle is enforced by
tests/test_torch_encode.py.

`available()` builds and initialises the core on first call and raises
when the build fails: the lossy path never falls back to the numpy oracle.
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np

from vvc_torch.packer import recon_lib
from vvc_torch.rom.transform_mats import dct2_matrix, dst7_matrix, dct8_matrix

_initialized = False
_init_lock = threading.Lock()


def available() -> bool:
    global _initialized
    l = recon_lib()
    with _init_lock:
        if _initialized:
            return True
        mats = ([np.ascontiguousarray(dct2_matrix(n)) for n in (4, 8, 16, 32, 64)]
                + [np.ascontiguousarray(dst7_matrix(n)) for n in (4, 8, 16, 32)]
                + [np.ascontiguousarray(dct8_matrix(n)) for n in (4, 8, 16, 32)])
        # keep refs alive for the process lifetime (recon_init copies anyway)
        l.recon_init(*[m.ctypes.data_as(ctypes.c_void_p) for m in mats])
        from vvc_torch.rom.mip_mats import mip_weights
        w8 = np.ascontiguousarray(mip_weights().astype(np.int8))
        l.mip_init(w8.ctypes.data_as(ctypes.c_void_p))
        from vvc_torch.rom.lfnst_mats import lfnst_kernels
        k8 = np.ascontiguousarray(lfnst_kernels().astype(np.int8))
        l.lfnst_init(k8.ctypes.data_as(ctypes.c_void_p))
        from vvc_torch.rom.intra_filters import fc_filters, fg_filters
        fc = np.ascontiguousarray(fc_filters())
        fg = np.ascontiguousarray(fg_filters())
        l.intra_filt_init(fc.ctypes.data_as(ctypes.c_void_p),
                          fg.ctypes.data_as(ctypes.c_void_p))
        from vvc_torch.cabac.rates import (level_bits_scalar, LEVEL_BITS_TABLE,
                                           _EG_SLOPE)
        lut = np.ascontiguousarray(
            [level_bits_scalar(v) for v in range(4096)], dtype=np.float64)
        l.depquant_init(lut.ctypes.data_as(ctypes.c_void_p), len(lut),
                        len(LEVEL_BITS_TABLE), float(_EG_SLOPE))
        _initialized = True
    return True


def _p(a):
    return a.ctypes.data_as(ctypes.c_void_p) if a is not None else None


def _run_component_v2(l, leaves, plane, coded, orig, qp, bit_depth, enc,
                      comp, meta, preds, dep_quant, dq_lam, cs=None,
                      luma_plane=None):
    """v2 pass: full leaf feature set (rect/ISP/MRL/inter/dep-quant/LMCS).

    meta: shared [n,16] record array (luma coords); preds: {i: pred_plane}
    per-component inter predictions from the decision pass / MC prepass."""
    n = len(leaves)
    if n == 0:
        return
    attr = ("lev_y", "lev_cb", "lev_cr")[comp]
    offsets = np.empty((n,), dtype=np.int64)
    pred_off = np.full((n,), -1, dtype=np.int64)
    total = 0
    ptotal = 0
    dims = []
    for i, leaf in enumerate(leaves):
        bw, bh = (leaf.w, leaf.h) if comp == 0 else (leaf.w >> 1,
                                                     leaf.h >> 1)
        dims.append((bw, bh))
        offsets[i] = total
        total += bw * bh
        if i in preds:
            pred_off[i] = ptotal
            ptotal += bw * bh
    levels = np.zeros((total,), dtype=np.int32)
    pbuf = np.zeros((max(ptotal, 1),), dtype=np.int32)
    for i, p in preds.items():
        bw, bh = dims[i]
        pbuf[pred_off[i]:pred_off[i] + bw * bh] = \
            np.asarray(p[comp], dtype=np.int32).reshape(-1)
    cbf = np.zeros((n,), dtype=np.int32)
    if not enc:
        for i, leaf in enumerate(leaves):
            lv = getattr(leaf, attr)
            if lv is not None:
                bw, bh = dims[i]
                levels[offsets[i]:offsets[i] + bw * bh] = lv.reshape(-1)
                cbf[i] = 1
    h, w = plane.shape
    cs_starts = cs_fwd = cs_inv = None
    if cs is not None:
        cs_starts, cs_fwd, cs_inv = cs
    lh = lw = 0
    if luma_plane is not None:
        lh, lw = luma_plane.shape
    l.recon_leaves_v2(
        _p(plane), h, w, _p(coded), coded.shape[1], _p(orig), _p(meta), n,
        _p(levels), _p(offsets), _p(cbf), _p(pbuf), _p(pred_off),
        qp, bit_depth, 2, int(enc), int(dep_quant), float(dq_lam),
        _p(cs_starts), _p(cs_fwd), _p(cs_inv),
        _p(luma_plane), lh, lw, comp)
    if enc:
        for i, leaf in enumerate(leaves):
            if cbf[i]:
                bw, bh = dims[i]
                setattr(leaf, attr,
                        levels[offsets[i]:offsets[i] + bw * bh]
                        .reshape(bh, bw).copy())
            else:
                setattr(leaf, attr, None)


def reconstruct_leaves_native_v2(leaves, recon_planes, qp: int,
                                 bit_depth: int, orig_planes=None,
                                 chroma_qp_fn=None, dep_quant: bool = False,
                                 pred_cache=None, lmcs_chroma=None):
    """Full-tool native reconstruction (mirror of reconstruct_leaves for
    the lossy tool set; lossless/BDPCM stay on the numpy oracle path)."""
    assert available()
    from vvc_torch.kernels.transform import MTS_TR
    from vvc_torch.kernels.depquant import LAMBDA_T
    l = recon_lib()
    y_pl, cb_pl, cr_pl = recon_planes
    h, w = y_pl.shape
    for p in recon_planes:
        assert p.dtype == np.int32 and p.flags.c_contiguous, \
            "recon planes must be contiguous int32"
    n = len(leaves)
    meta = np.zeros((n, 16), dtype=np.int32)
    for i, leaf in enumerate(leaves):
        th, tv = MTS_TR[leaf.mts]
        meta[i, :13] = (leaf.x0, leaf.y0, leaf.w, leaf.h, leaf.pred,
                        leaf.luma_mode, int(th), int(tv), leaf.lfnst,
                        leaf.chroma_mode, leaf.isp, leaf.mrl,
                        int(leaf.ciip))
    coded_y = np.zeros(((h + 3) >> 2, (w + 3) >> 2), dtype=np.uint8)
    coded_c = np.zeros(((h // 2 + 3) >> 2, (w // 2 + 3) >> 2),
                       dtype=np.uint8)
    coded_c2 = coded_c.copy()
    qpc = chroma_qp_fn(qp) if chroma_qp_fn else min(qp, 63)
    enc = orig_planes is not None
    origs = ([np.ascontiguousarray(p, dtype=np.int32) for p in orig_planes]
             if enc else [None, None, None])
    cs = None
    if lmcs_chroma is not None:
        from vvc_torch.kernels.lmcs import chroma_scale_factors
        cs_fwd, cs_inv = chroma_scale_factors(lmcs_chroma, bit_depth)
        cs_starts = np.ascontiguousarray(np.concatenate(
            [[0], np.cumsum(np.asarray(lmcs_chroma, np.int64))]))
        cs = (cs_starts, np.ascontiguousarray(cs_fwd),
              np.ascontiguousarray(cs_inv))
    preds = pred_cache if pred_cache is not None else {}
    _run_component_v2(l, leaves, y_pl, coded_y, origs[0], qp, bit_depth,
                      enc, 0, meta, preds, dep_quant, LAMBDA_T)
    _run_component_v2(l, leaves, cb_pl, coded_c, origs[1], qpc, bit_depth,
                      enc, 1, meta, preds, dep_quant, LAMBDA_T, cs=cs,
                      luma_plane=y_pl)
    _run_component_v2(l, leaves, cr_pl, coded_c2, origs[2], qpc, bit_depth,
                      enc, 2, meta, preds, dep_quant, LAMBDA_T, cs=cs,
                      luma_plane=y_pl)

"""Native BinEncoder/BinDecoder wrappers — drop-in replacements for the
Python engine (vvc_torch.cabac.engine) backed by libcabac.so.

Same interface as BinEncoder/BinDecoder plus batched `write_residual` /
`read_residual` fast paths (the reference's residual_coding hot loop runs
entirely native, one ctypes call per TB instead of one per bin).  Context
state lives in the SliceContexts numpy array shared with any Python-side
syntax coding.
"""
from __future__ import annotations

import ctypes

import numpy as np

from vvc_torch.packer import lib


def _ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.c_void_p)


class NativeBinEncoder:
    def __init__(self, ctxs=None):
        self._l = lib()
        assert self._l is not None, "native packer unavailable"
        self._h = self._l.enc_create()
        self._sp = None
        self._op = None
        self._off = None
        if ctxs is not None:
            self.bind(ctxs)

    def bind(self, ctxs):
        """Cache pointers into the SliceContexts state array (all contexts
        passed to encode_bin must come from this object)."""
        self._states = ctxs.states  # keep alive
        self._sp = _ptr(ctxs.states)
        self._off = np.ascontiguousarray(ctxs.residual_offsets())
        self._op = _ptr(self._off)

    def encode_bin(self, bin_val: int, ctx):
        # ctx is a vvc_torch.cabac.ctx.CtxRef — shared state array + index
        sp = self._sp if self._sp is not None else _ptr(ctx._a)
        self._l.enc_bin(self._h, sp, ctx._i, bin_val)

    def encode_bin_ep(self, bin_val: int):
        self._l.enc_ep(self._h, bin_val)

    def encode_bins_ep(self, value: int, nbits: int):
        self._l.enc_eps(self._h, value, nbits)

    def encode_bin_trm(self, bin_val: int):
        self._l.enc_trm(self._h, bin_val)

    def write_residual(self, ctxs, levels: np.ndarray, is_luma: bool):
        lv = np.ascontiguousarray(levels, dtype=np.int32)
        if self._sp is None:
            self.bind(ctxs)
        self._l.enc_residual_c(self._h, self._sp, self._op, _ptr(lv),
                               lv.shape[1], lv.shape[0], int(is_luma))

    def finish(self) -> bytes:
        cap = (int(self._l.enc_bit_count(self._h)) >> 3) + 64
        buf = (ctypes.c_uint8 * cap)()
        n = self._l.enc_finish(self._h, buf, cap)
        assert n >= 0, "packer output exceeded buffer"
        return bytes(buf[:n])

    @property
    def bit_count(self) -> int:
        return int(self._l.enc_bit_count(self._h))

    def __del__(self):
        if getattr(self, "_h", None) and self._l:
            self._l.enc_destroy(self._h)
            self._h = None


# context-set order consumed by the native tree writer — keep in sync with
# the TwSet enum in cabac_core.cpp
TW_SET_ORDER = [
    "SPLIT_CU_FLAG", "SAO_TYPE", "SAO_MERGE", "INTRA_LUMA_REF_IDX",
    "INTRA_LUMA_MPM_FLAG", "INTRA_LUMA_NOT_PLANAR",
    "INTRA_CHROMA_PRED_MODE", "CCLM_FLAG", "CCLM_MODE", "CBF_LUMA",
    "MTS_IDX", "LFNST_IDX", "CBF_CB", "CBF_CR", "MIP_FLAG",
]


def serialize_leaves(leaves):
    """Leaf list (traversal order) → (records [N,10] int32, levels buffer).

    Record layout mirrors the LeafRec enum in cabac_core.cpp; level offsets
    are -1 when the component has no coded residual (cbf = 0)."""
    n = len(leaves)
    recs = np.empty((n, 10), dtype=np.int32)
    parts = []
    off = 0
    for i, l in enumerate(leaves):
        offs = []
        for lv in (l.lev_y, l.lev_cb, l.lev_cr):
            if lv is not None and lv.any():
                parts.append(np.ascontiguousarray(lv, dtype=np.int32).ravel())
                offs.append(off)
                off += lv.size
            else:
                offs.append(-1)
        recs[i] = (l.x0, l.y0, l.size, l.luma_mode, l.mts, l.lfnst,
                   l.chroma_mode, offs[0], offs[1], offs[2])
    buf = (np.concatenate(parts) if parts
           else np.zeros(1, dtype=np.int32))
    return recs, buf


def build_size_map(leaves, width: int, height: int, min_cu: int):
    """Per-min-CU grid of leaf size log2 (the native walker re-derives the
    quadtree from it)."""
    sm = np.zeros((height // min_cu, width // min_cu), dtype=np.uint8)
    for l in leaves:
        lg = l.size.bit_length() - 1
        sm[l.y0 // min_cu:(l.y0 + l.size) // min_cu,
           l.x0 // min_cu:(l.x0 + l.size) // min_cu] = lg
    return sm


def serialize_sao(sao_params, width: int, height: int, ctu: int):
    """{(x0,y0): (p_y, p_cb, p_cr)} → [n_ctus, 21] int32 (3 × 7 fields)."""
    nx = (width + ctu - 1) // ctu
    ny = (height + ctu - 1) // ctu
    arr = np.zeros((ny * nx, 21), dtype=np.int32)
    for (x0, y0), ps in sao_params.items():
        ci = (y0 // ctu) * nx + (x0 // ctu)
        for c, p in enumerate(ps):
            arr[ci, c * 7:(c + 1) * 7] = (p.mode, p.eo_class, p.band_pos,
                                          *p.offsets)
    return arr, nx


class NativeTreeWriter:
    """Native CU-syntax writer (intra slices): one C call per tile / WPP
    row replaces the per-CU Python TreeWriter loop.  Byte-equal to the
    Python writer (tests/test_packer.py)."""

    def __init__(self, width, height, ctu, min_cu,
                 mts=False, cclm=False, mip=False, lfnst=False):
        self._l = lib()
        flags = (int(mts) | int(cclm) << 1 | int(mip) << 2 | int(lfnst) << 3)
        self._h = self._l.tw_create(width, height, ctu, min_cu, flags)

    def write(self, enc: NativeBinEncoder, ctxs, size_map, recs, levels,
              sao_arr, sao_stride, cx0, cx1, cy0, cy1, tile_x0,
              snapshot: bool = False):
        """Returns the WPP context snapshot (after first CTU) or None."""
        set_off = np.array([ctxs.index(nm, 0) for nm in TW_SET_ORDER],
                           dtype=np.int32)
        res_off = np.ascontiguousarray(ctxs.residual_offsets())
        snap = (np.empty_like(ctxs.states) if snapshot else None)
        self._l.tw_write(
            self._h, enc._h, _ptr(ctxs.states), _ptr(set_off), _ptr(res_off),
            _ptr(size_map), size_map.shape[1], _ptr(recs), _ptr(levels),
            _ptr(sao_arr) if sao_arr is not None else None,
            sao_stride, cx0, cx1, cy0, cy1, tile_x0,
            _ptr(snap) if snapshot else None, ctxs.states.shape[0])
        return snap

    def __del__(self):
        if getattr(self, "_h", None) and self._l:
            self._l.tw_destroy(self._h)
            self._h = None


class NativeBinDecoder:
    def __init__(self, data: bytes, ctxs=None):
        self._l = lib()
        assert self._l is not None, "native packer unavailable"
        self._buf = np.frombuffer(data, dtype=np.uint8).copy()
        if self._buf.size == 0:
            self._buf = np.zeros(1, dtype=np.uint8)
        self._h = self._l.dec_create(_ptr(self._buf), len(data))
        self._sp = None
        self._op = None
        self._off = None
        if ctxs is not None:
            self.bind(ctxs)

    def bind(self, ctxs):
        self._states = ctxs.states
        self._sp = _ptr(ctxs.states)
        self._off = np.ascontiguousarray(ctxs.residual_offsets())
        self._op = _ptr(self._off)

    def decode_bin(self, ctx) -> int:
        sp = self._sp if self._sp is not None else _ptr(ctx._a)
        return self._l.dec_bin(self._h, sp, ctx._i)

    def decode_bin_ep(self) -> int:
        return self._l.dec_ep(self._h)

    def decode_bins_ep(self, nbits: int) -> int:
        return int(self._l.dec_eps(self._h, nbits))

    def decode_bin_trm(self) -> int:
        return self._l.dec_trm(self._h)

    def read_residual(self, ctxs, size, is_luma: bool) -> np.ndarray:
        w, h = (size, size) if isinstance(size, int) else size
        out = np.zeros((h, w), dtype=np.int32)
        if self._sp is None:
            self.bind(ctxs)
        self._l.dec_residual_c(self._h, self._sp, self._op,
                               _ptr(out), int(w), int(h), int(is_luma))
        return out

    def __del__(self):
        if getattr(self, "_h", None) and self._l:
            self._l.dec_destroy(self._h)
            self._h = None


# context-set order consumed by the native tree READER — keep in sync
# with the TrSet enum in cabac_core.cpp
TR_SET_ORDER = [
    "SPLIT_CU_FLAG", "SPLIT_QT_FLAG", "MTT_SPLIT_VERT", "MTT_SPLIT_BINARY",
    "SAO_TYPE", "SAO_MERGE",
    "CU_SKIP_FLAG", "PRED_MODE", "MERGE_FLAG", "MERGE_IDX",
    "GPM_FLAG", "GPM_IDX", "MMVD_FLAG", "MMVD_CAND", "MMVD_DIST",
    "CIIP_FLAG", "AFFINE_FLAG", "AFFINE_TYPE", "INTER_DIR", "REF_IDX",
    "MVP_FLAG", "MVD", "IMV_FLAG", "SMVD_FLAG", "BCW_IDX", "ROOT_CBF",
    "MIP_FLAG", "INTRA_LUMA_REF_IDX", "ISP_MODE", "INTRA_LUMA_MPM_FLAG",
    "INTRA_LUMA_NOT_PLANAR",
    "CCLM_FLAG", "CCLM_MODE", "INTRA_CHROMA_PRED_MODE",
    "CBF_LUMA", "MTS_IDX", "LFNST_IDX", "CBF_CB", "CBF_CR",
]

TR_NREC = 56

# tool-flag bits for tr_create — keep in sync with TrFlag in
# cabac_core.cpp
TR_F_MTS, TR_F_CCLM, TR_F_MIP, TR_F_LFNST = 1, 2, 4, 8
TR_F_ISP, TR_F_MTT, TR_F_AFFINE, TR_F_MMVD = 16, 32, 64, 128
TR_F_CIIP, TR_F_GPM, TR_F_AMVR, TR_F_SMVD = 256, 512, 1024, 2048
TR_F_BCW, TR_F_HAS_SMVD_REFS = 4096, 8192


class NativeTreeReader:
    """Native full-tool-set CU syntax parser (decoder): one C call per
    tile / WPP row emits flat leaf records + a level buffer; Python then
    derives merge/AMVP motion from the records (parse ∥ derive split —
    OpenVVC vcl/drv architecture, SURVEY §2.6).  Non-lossless only."""

    def __init__(self, width, height, ctu, min_cu, flags, slice_type,
                 n_ref0, n_ref1, max_merge):
        self._l = lib()
        self._h = self._l.tr_create(width, height, ctu, min_cu, flags,
                                    slice_type, n_ref0, n_ref1, max_merge)
        self._wh = (width, height)
        self._ctu = ctu

    def read(self, dec: NativeBinDecoder, ctxs, cx0, cx1, cy0, cy1,
             sao_arr=None, sao_stride=0, tile_x0=0, tile_y0=0,
             snapshot=False, rec_cap=None):
        """Parses CTUs [cx0,cx1)×[cy0,cy1).  Returns (recs [N, TR_NREC],
        levels int32, snapshot|None)."""
        w, h = self._wh
        if rec_cap is None:
            span_x = max(1, cx1 - cx0)
            span_y = max(1, cy1 - cy0)
            rec_cap = (span_x // 8 + 2) * (span_y // 8 + 2) * 2
        lev_cap = max(1 << 16, (cx1 - cx0 + 64) * (cy1 - cy0 + 64) * 3)
        recs = np.empty((rec_cap, TR_NREC), dtype=np.int32)
        levels = np.empty(lev_cap, dtype=np.int32)
        set_off = np.array([ctxs.index(nm, 0) for nm in TR_SET_ORDER],
                           dtype=np.int32)
        res_off = np.ascontiguousarray(ctxs.residual_offsets())
        snap = np.empty_like(ctxs.states) if snapshot else None
        lev_used = ctypes.c_int64(0)
        n = self._l.tr_read(
            self._h, dec._h, _ptr(ctxs.states), _ptr(set_off),
            _ptr(res_off), cx0, cx1, cy0, cy1,
            _ptr(recs), rec_cap, _ptr(levels), lev_cap,
            _ptr(sao_arr) if sao_arr is not None else None,
            sao_stride, tile_x0, tile_y0,
            _ptr(snap) if snapshot else None, ctxs.states.shape[0],
            ctypes.byref(lev_used))
        if n < 0:
            raise ValueError("native tree reader buffer overflow "
                             "(corrupt stream?)")
        return recs[:n], levels[:lev_used.value], snap

    def __del__(self):
        if getattr(self, "_h", None) and self._l:
            self._l.tr_destroy(self._h)
            self._h = None

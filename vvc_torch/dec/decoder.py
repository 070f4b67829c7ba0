"""Decoder entry point: Annex-B bitstream → frames.

Port of vvc/dec/decoder.py.  The parse, the leaf derivation, the
sequential reconstruction (the native recon core) and the in-loop filters
are host code, copied with their imports rewritten; `wavefront=True`
reconstructs intra pictures on the device through vvc_torch.dec.wavefront
and its CUDA kernels.  `device=None` means CUDA and raises where CUDA is
absent; only `device="cpu"` runs the kernels' plain twins.

TPU-native analog of the reference's decoder stack
(`VTM/source/Lib/DecoderLib/DecLib.cpp` → DecLib::decode NAL
dispatch / xActivateParameterSets; DecSlice.cpp → decompressSlice;
DecCu.cpp → decompressCtu; hash check: DecLib calcAndPrintHashStatus).
OpenVVC counterpart: libovvc/ovdec.c submit/receive, slicedec.c, ctudec.c.

Two-phase per picture (the OpenVVC drv/rcn split, SURVEY.md §3.3): parse
the whole slice's syntax into a leaf list (host CABAC), then reconstruct
in z-order with the *same* kernel path the encoder used
(vvc_torch.model.recon.reconstruct_leaves) — guaranteeing bit-exactness.
"""
from __future__ import annotations

import hashlib
import threading

import numpy as np

from vvc_torch import ops
from vvc_torch.common.types import NalUnitType
from vvc_torch.io.nal import read_annexb
from vvc_torch.io.yuv import Frame
from vvc_torch.hls.parse import parse_sps, parse_pps, parse_slice_header
from vvc_torch.packer import native as native_packer
from vvc_torch.cabac.ctx import SliceContexts
from vvc_torch.cabac.cu_syntax import TreeReader
from vvc_torch.model.frame import CodingState
from vvc_torch.model.recon import reconstruct_leaves


class HashMismatch(Exception):
    pass


def decode_stream(data: bytes, verify_hash: bool = True,
                  wavefront: bool = False, device=None):
    """Decode an Annex-B byte stream → (frames, info dict).

    wavefront=True reconstructs on the batched device path
    (vvc_torch.dec.wavefront) instead of the sequential host core —
    bit-exact either way (test-enforced).  `device`: None means CUDA
    (raises where it is absent), "cpu" the kernels' plain twins; the host
    path (wavefront=False) does no device work."""
    device = ops.resolve_device(device)
    sps = None
    pps = None
    frames = []          # decode order
    pocs = []
    dpb = {}             # poc -> Frame (reference: DecLib m_cListPic)
    col_dpb = {}         # poc -> ColMotion (TMVP)
    hash_status = []
    aps_store = {}       # (params_type, id) -> payload (APS pool,
                         # reference: ParameterSetManager)
    for nal in read_annexb(data):
        if nal.nal_type == NalUnitType.SPS:
            sps = parse_sps(nal.payload)
        elif nal.nal_type == NalUnitType.PPS:
            pps = parse_pps(nal.payload)
        elif nal.nal_type in (NalUnitType.PREFIX_APS,
                              NalUnitType.SUFFIX_APS):
            from vvc_torch.hls.aps import parse_aps
            t, aps_id, payload = parse_aps(nal.payload)
            aps_store[(t, aps_id)] = payload
        elif nal.nal_type in (NalUnitType.IDR_N_LP, NalUnitType.IDR_W_RADL,
                              NalUnitType.TRAIL, NalUnitType.CRA):
            assert sps is not None and pps is not None, "slice before SPS/PPS"
            frame, poc, retained = _decode_slice(
                nal.payload, sps, pps, wavefront, dpb, col_dpb, aps_store,
                device)
            frames.append(frame)
            pocs.append(poc)
            dpb[poc] = frame
            # RPL-based DPB marking (spec:
            # Slice::applyReferencePictureListBasedMarking): the header's
            # retention list names every picture a later picture still
            # references; drop the rest (replaces the r4 POC-64 window)
            keep = {poc} | {poc - d for d in retained}
            for p in [p for p in dpb if p not in keep]:
                del dpb[p]
                col_dpb.pop(p, None)
        elif nal.nal_type == NalUnitType.SUFFIX_SEI:
            st = _check_hash_sei(nal.payload, frames[-1]) if frames else None
            hash_status.append(st)
            if verify_hash and st is False:
                raise HashMismatch(f"picture {len(frames) - 1} hash mismatch")
    # output (display) order = POC order (reference: DPB bumping)
    out = [f for _, f in sorted(zip(pocs, frames), key=lambda t: t[0])]
    return out, {"sps": sps, "pps": pps, "hash_ok": hash_status,
                 "decode_order_pocs": pocs}


def _decode_slice(rbsp: bytes, sps, pps, wavefront: bool = False,
                  dpb: dict | None = None, col_dpb: dict | None = None,
                  aps_store: dict | None = None, device=None):
    from vvc_torch.enc.encoder import tile_columns, tile_grid  # geometry
    from vvc_torch.model.motion import MotionState, motion_field_from_leaves

    cols = tile_columns(pps.num_tile_cols, sps.width, sps.ctu_size)
    rows = tile_columns(pps.num_tile_rows, sps.height, sps.ctu_size)
    tiles = tile_grid(pps.num_tile_cols, pps.num_tile_rows, sps.width,
                      sps.height, sps.ctu_size)
    n_rows = -(-sps.height // sps.ctu_size)
    n_sub = n_rows if pps.wpp else len(tiles)
    n_ctus = (-(-sps.width // sps.ctu_size)) * n_rows
    sh, substreams, alf_hdr, lmcs_cw = parse_slice_header(
        rbsp, pps.init_qp, n_sub, alf_enabled=sps.alf, n_ctus=n_ctus,
        lmcs_enabled=sps.lmcs)
    # resolve APS references (spec: slice header activates APS by id)
    from vvc_torch.hls.aps import APS_ALF, APS_LMCS
    if isinstance(lmcs_cw, tuple) and lmcs_cw and lmcs_cw[0] == "aps":
        lmcs_cw = (aps_store or {})[(APS_LMCS, lmcs_cw[1])]
    if alf_hdr is not None:
        luma_ref, flag_list, chroma_ref = alf_hdr
        luma = chroma = cc_cb = cc_cr = None
        if luma_ref is not None:
            luma = (aps_store or {})[(APS_ALF, luma_ref[1])][0]
        if chroma_ref is not None:
            _, chroma, cc_cb, cc_cr = (aps_store or {})[
                (APS_ALF, chroma_ref[1])]
        alf_hdr = (luma, flag_list, chroma, cc_cb, cc_cr)
    # reference picture lists from POC deltas (reference:
    # Slice::constructRefPicList)
    refs_l0 = [dpb[sh.poc - d] for d in sh.l0_deltas]
    refs_l1 = [dpb[sh.poc - d] for d in sh.l1_deltas]
    refs = ([(f.y, f.cb, f.cr) for f in refs_l0],
            [(f.y, f.cb, f.cr) for f in refs_l1])
    n_ref = (len(refs_l0), len(refs_l1))
    inter = sh.slice_type != 2
    ref_pocs = (tuple(sh.poc - d for d in sh.l0_deltas),
                tuple(sh.poc - d for d in sh.l1_deltas))
    col = None
    if col_dpb is not None:
        if sh.slice_type == 0 and ref_pocs[1]:
            col = col_dpb.get(ref_pocs[1][0])
        elif sh.slice_type == 1 and ref_pocs[0]:
            col = col_dpb.get(ref_pocs[0][0])
    recon = (np.zeros((sps.height, sps.width), dtype=np.int32),
             np.zeros((sps.height // 2, sps.width // 2), dtype=np.int32),
             np.zeros((sps.height // 2, sps.width // 2), dtype=np.int32))
    all_leaves = []

    sao_params = {}
    # with wavefront=True the tiles are reconstructed one after another in
    # tile order (their parses still overlap): a device call uploads the
    # planes and writes back only its own leaves, and a tile's CCLM
    # downsampling reads the last luma column of the tile to its left
    done = [threading.Event() for _ in tiles]

    def _recon(leaves, turn=0):
        if wavefront and turn > 0:
            done[turn - 1].wait()
        if (wavefront and not inter and not sps.dep_quant
                and lmcs_cw is None
                and all(l.w == l.h and not l.isp and not l.mrl
                        for l in leaves)):
            from vvc_torch.dec.wavefront import reconstruct_leaves_wavefront
            reconstruct_leaves_wavefront(leaves, recon, sh.qp,
                                         sps.bit_depth, sps.lossless,
                                         device=device)
        else:
            inter_cfg = None
            fwd_lut = None
            if inter:
                inter_cfg = {"bdof": sps.bdof, "dmvr": sps.dmvr,
                             "cur_poc": sh.poc, "ref_pocs": ref_pocs}
                if lmcs_cw is not None:
                    # inter slices: MC preds (original-domain refs) are
                    # forward-mapped before residual addition (Reshape)
                    from vvc_torch.kernels.lmcs import build_luts
                    fwd_lut, _ = build_luts(lmcs_cw, sps.bit_depth)
            reconstruct_leaves(leaves, recon, sh.qp, sps.bit_depth,
                               lossless=sps.lossless,
                               refs=refs if inter else None,
                               dep_quant=sps.dep_quant,
                               inter_cfg=inter_cfg,
                               lmcs_chroma=lmcs_cw,
                               lmcs_fwd_lut=fwd_lut)

    # native full-tool-set parser (cabac_core.cpp tr_read): one C call
    # per row/tile replaces the per-bin Python syntax loop — the decode
    # wall.  Lossless/trace streams use the Python path.  The native core
    # is built at first use (a failed build raises; no fallback).
    from vvc_torch.utils.trace import active as _trace
    import os as _os
    use_native_tr = (not sps.lossless and not _trace().enabled
                     and not _os.environ.get("VVC_NO_NATIVE_TR"))

    def _tr_flags():
        f = 0
        for on, bit in ((sps.mts_intra, native_packer.TR_F_MTS),
                        (sps.cclm, native_packer.TR_F_CCLM),
                        (sps.mip, native_packer.TR_F_MIP),
                        (sps.lfnst, native_packer.TR_F_LFNST),
                        (sps.isp, native_packer.TR_F_ISP),
                        (sps.max_mtt_depth_intra > 0,
                         native_packer.TR_F_MTT),
                        (sps.affine, native_packer.TR_F_AFFINE),
                        (sps.mmvd, native_packer.TR_F_MMVD),
                        (sps.ciip, native_packer.TR_F_CIIP),
                        (sps.gpm, native_packer.TR_F_GPM),
                        (sps.amvr, native_packer.TR_F_AMVR),
                        (sps.smvd, native_packer.TR_F_SMVD),
                        (sps.bcw, native_packer.TR_F_BCW)):
            if on:
                f |= bit
        if _smvd_ref_pair() is not None:
            f |= native_packer.TR_F_HAS_SMVD_REFS
        return f

    def _smvd_ref_pair():
        l0p, l1p = ref_pocs
        past = [(sh.poc - p, i) for i, p in enumerate(l0p) if p < sh.poc]
        fut = [(p - sh.poc, i) for i, p in enumerate(l1p) if p > sh.poc]
        if not past or not fut:
            return None
        return (min(past)[1], min(fut)[1])

    nx_ctu = -(-sps.width // sps.ctu_size)
    ny_ctu = -(-sps.height // sps.ctu_size)

    def _sao_from_arr(arr, cx0, cx1, cy0, cy1, out):
        from vvc_torch.kernels.sao import SaoParams
        cs = sps.ctu_size
        for cy in range(cy0, cy1, cs):
            for cx in range(cx0, cx1, cs):
                ci = (cy // cs) * nx_ctu + (cx // cs)
                ps = []
                for c in range(3):
                    q = arr[ci, c * 7:(c + 1) * 7]
                    ps.append(SaoParams(int(q[0]), int(q[1]), int(q[2]),
                                        tuple(int(v) for v in q[3:7])))
                out[(cx, cy)] = tuple(ps)

    def _derive(recs, lev, mstate):
        from vvc_torch.dec.record_derive import derive_leaves
        return derive_leaves(
            recs, lev, None, mstate, sh.slice_type, n_ref, 6, col,
            sh.poc, ref_pocs, _smvd_ref_pair(), sps.ctu_size)

    def do_wpp_rows_native():
        mstate = MotionState(sps.width, sps.height)
        tr = native_packer.NativeTreeReader(
            sps.width, sps.height, sps.ctu_size, sps.min_cu_size,
            _tr_flags(), sh.slice_type, n_ref[0], n_ref[1], 6)
        sao_arr = (np.zeros((nx_ctu * ny_ctu, 21), np.int32)
                   if sps.sao else None)
        leaves = []
        inherit = None
        for r, cy in enumerate(range(0, sps.height, sps.ctu_size)):
            ctxs = SliceContexts(sh.qp)
            if inherit is not None:
                ctxs.states[:] = inherit
            dec = native_packer.NativeBinDecoder(substreams[r], ctxs)
            recs, lev, snap = tr.read(
                dec, ctxs, 0, sps.width, cy, cy + sps.ctu_size,
                sao_arr=sao_arr, sao_stride=nx_ctu, snapshot=True)
            assert dec.decode_bin_trm() == 1, "row substream termination"
            inherit = snap
            leaves.extend(_derive(recs, lev, mstate))
        if sao_arr is not None:
            _sao_from_arr(sao_arr, 0, sps.width, 0, sps.height, sao_params)
        _recon(leaves)
        return leaves

    def do_tile_native(i):
        tx0, tx1, ty0, ty1 = tiles[i]
        ctxs = SliceContexts(sh.qp)
        dec = native_packer.NativeBinDecoder(substreams[i], ctxs)
        mstate = MotionState(sps.width, sps.height)
        tr = native_packer.NativeTreeReader(
            sps.width, sps.height, sps.ctu_size, sps.min_cu_size,
            _tr_flags(), sh.slice_type, n_ref[0], n_ref[1], 6)
        sao_arr = (np.zeros((nx_ctu * ny_ctu, 21), np.int32)
                   if sps.sao else None)
        recs, lev, _ = tr.read(dec, ctxs, tx0, min(tx1, sps.width),
                               ty0, min(ty1, sps.height),
                               sao_arr=sao_arr, sao_stride=nx_ctu,
                               tile_x0=tx0, tile_y0=ty0)
        assert dec.decode_bin_trm() == 1, \
            "tile substream termination missing"
        local_sao = {}
        if sao_arr is not None:
            _sao_from_arr(sao_arr, tx0, min(tx1, sps.width), ty0,
                          min(ty1, sps.height), local_sao)
        leaves = _derive(recs, lev, mstate)
        _recon(leaves, i)
        return leaves, local_sao

    def do_wpp_rows():
        from vvc_torch.cabac.sao_syntax import read_sao_params
        state = CodingState(sps.width, sps.height)
        mstate = MotionState(sps.width, sps.height)
        leaves = []
        inherit = None
        for r, cy in enumerate(range(0, sps.height, sps.ctu_size)):
            ctxs = SliceContexts(sh.qp)
            if inherit is not None:
                ctxs.states[:] = inherit
            dec = native_packer.NativeBinDecoder(substreams[r], ctxs)
            reader = TreeReader(dec, ctxs, state, sps.width, sps.height,
                                sps.ctu_size, sps.min_cu_size,
                                mts_enabled=sps.mts_intra,
                                cclm_enabled=sps.cclm, mip_enabled=sps.mip,
                            lfnst_enabled=sps.lfnst, isp_enabled=sps.isp,
                            mtt_enabled=sps.max_mtt_depth_intra > 0,
                            affine_enabled=sps.affine,
                            lossless_enabled=sps.lossless,
                            mmvd_enabled=sps.mmvd,
                            ciip_enabled=sps.ciip,
                            gpm_enabled=sps.gpm,
                            amvr_enabled=sps.amvr,
                            smvd_enabled=sps.smvd,
                            bcw_enabled=sps.bcw,
                                slice_type=sh.slice_type, mstate=mstate,
                                n_ref=n_ref, col=col, cur_poc=sh.poc,
                                ref_pocs=ref_pocs)
            first = True
            for cx in range(0, sps.width, sps.ctu_size):
                if sps.sao:
                    cs = sps.ctu_size
                    sao_params[(cx, cy)] = read_sao_params(
                        dec, ctxs, left=sao_params.get((cx - cs, cy)),
                        up=sao_params.get((cx, cy - cs)))
                reader.read_ctu(cx, cy)
                if first:
                    inherit = ctxs.states.copy()
                    first = False
            assert dec.decode_bin_trm() == 1, "row substream termination"
            leaves.extend(reader.leaves)
        _recon(leaves)
        return leaves

    def do_tile(i):
        from vvc_torch.cabac.sao_syntax import read_sao_params
        tx0, tx1, ty0, ty1 = tiles[i]
        payload = substreams[i]
        ctxs = SliceContexts(sh.qp)
        dec = native_packer.NativeBinDecoder(payload, ctxs)
        state = CodingState(sps.width, sps.height)
        reader = TreeReader(dec, ctxs, state, min(tx1, sps.width), sps.height,
                            sps.ctu_size, sps.min_cu_size,
                            mts_enabled=sps.mts_intra,
                            cclm_enabled=sps.cclm, mip_enabled=sps.mip,
                            lfnst_enabled=sps.lfnst, isp_enabled=sps.isp,
                            mtt_enabled=sps.max_mtt_depth_intra > 0,
                            affine_enabled=sps.affine,
                            lossless_enabled=sps.lossless,
                            mmvd_enabled=sps.mmvd,
                            ciip_enabled=sps.ciip,
                            gpm_enabled=sps.gpm,
                            amvr_enabled=sps.amvr,
                            smvd_enabled=sps.smvd,
                            bcw_enabled=sps.bcw,
                            slice_type=sh.slice_type,
                            mstate=MotionState(sps.width, sps.height),
                            n_ref=n_ref, col=col, cur_poc=sh.poc,
                            ref_pocs=ref_pocs)
        local_sao = {}
        for cy in range(ty0, ty1, sps.ctu_size):
            for cx in range(tx0, tx1, sps.ctu_size):
                if sps.sao:
                    cs = sps.ctu_size
                    local_sao[(cx, cy)] = read_sao_params(
                        dec, ctxs,
                        left=(local_sao.get((cx - cs, cy))
                              if cx - cs >= tx0 else None),
                        up=(local_sao.get((cx, cy - cs))
                            if cy - cs >= ty0 else None))
                reader.read_ctu(cx, cy)
        assert dec.decode_bin_trm() == 1, "tile substream termination missing"
        # per-tile recon — availability maps are fresh per call, so tile
        # isolation (no cross-tile prediction) holds by construction
        _recon(reader.leaves, i)
        return reader.leaves, local_sao

    def tile_fn(i):
        try:
            return (do_tile_native if use_native_tr else do_tile)(i)
        finally:
            done[i].set()

    if pps.wpp:
        all_leaves.extend(do_wpp_rows_native() if use_native_tr
                          else do_wpp_rows())
    elif len(tiles) > 1:
        import concurrent.futures
        with concurrent.futures.ThreadPoolExecutor(len(tiles)) as ex:
            for leaves, ls in ex.map(tile_fn, range(len(tiles))):
                all_leaves.extend(leaves)
                sao_params.update(ls)
    else:
        leaves, ls = tile_fn(0)
        all_leaves.extend(leaves)
        sao_params.update(ls)

    # LMCS: reconstruction happened in the mapped luma domain; inverse-map
    # before the in-loop filters (reference domain layout, Reshape.cpp)
    if sps.lmcs and lmcs_cw is not None:
        from vvc_torch.kernels.lmcs import build_luts, map_plane
        _, inv_lut = build_luts(lmcs_cw, sps.bit_depth)
        recon[0][:] = map_plane(recon[0], inv_lut)

    # in-loop filters (reference: DecLib::executeLoopFilters order)
    if sps.deblocking:
        from vvc_torch.kernels.deblock import deblock_frame
        deblock_frame(recon, all_leaves, sh.qp, sps.bit_depth,
                      tile_x_bounds=tuple(t[0] for t in cols[1:]),
                      tile_y_bounds=tuple(t[0] for t in rows[1:]))
    if sps.sao:
        from vvc_torch.kernels.sao import sao_filter_plane
        for comp in range(3):
            per_comp = {k: v[comp] for k, v in sao_params.items()}
            sao_filter_plane(recon[comp], per_comp, sps.ctu_size,
                             sps.bit_depth, tiles,
                             comp_scale=0 if comp == 0 else 1)
    if sps.alf and alf_hdr is not None:
        from vvc_torch.kernels.alf import (apply_alf_plane,
                                           apply_alf_classified)
        luma_c, flag_list, chroma_c, cc_cb, cc_cr = alf_hdr
        if luma_c is not None:
            flags = {}
            i = 0
            for y0 in range(0, sps.height, sps.ctu_size):
                for x0 in range(0, sps.width, sps.ctu_size):
                    flags[(x0, y0)] = flag_list[i]
                    i += 1
            apply_alf_classified(recon[0], *luma_c, sps.bit_depth, flags,
                                 sps.ctu_size)
        if chroma_c is not None:
            apply_alf_plane(recon[1], chroma_c, 2, sps.bit_depth)
            apply_alf_plane(recon[2], chroma_c, 2, sps.bit_depth)
        from vvc_torch.kernels.ccalf import apply_ccalf_delta
        if cc_cb is not None:
            recon[1][:] = apply_ccalf_delta(recon[1], recon[0], cc_cb,
                                            sps.bit_depth)
        if cc_cr is not None:
            recon[2][:] = apply_ccalf_delta(recon[2], recon[0], cc_cr,
                                            sps.bit_depth)
    if col_dpb is not None:
        col_dpb[sh.poc] = motion_field_from_leaves(
            all_leaves, sps.width, sps.height, sh.poc, ref_pocs)
    return Frame(*recon, sps.bit_depth), sh.poc, sh.retained_deltas


def _check_hash_sei(payload: bytes, frame: Frame):
    if payload[0] != 132:  # decoded_picture_hash
        return None
    body = payload[2:2 + payload[1]]
    if body[0] != 0:  # MD5
        return None
    ok = True
    off = 1
    dt = np.uint8 if frame.bit_depth == 8 else np.dtype("<u2")
    for p in frame.planes():
        digest = hashlib.md5(np.ascontiguousarray(p.astype(dt)).tobytes()).digest()
        ok &= digest == body[off:off + 16]
        off += 16
    return bool(ok)

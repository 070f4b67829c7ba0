"""Encoder: frames → Annex-B bitstream + reconstruction.

Port of vvc/enc/encoder.py (`Encoder`, `encode_sequence`) with `device`
threaded through to the RDO searches and the SAO/ALF encoder statistics,
the only device work.  It runs lossless All-Intra (slice 1) and lossy
All-Intra with MTS, MIP and deblocking (slice 2a), LFNST and the device
chroma decision, CCLM (slice 2b), SAO, ALF and CC-ALF (slice 3),
whose encoder statistics run on the device (csrc/sao_stats.cu,
csrc/alf_stats.cu) — the default lossy tool set of `encode_sequence` —
and the MTT lattice (QT/BT/TT), ISP, MRL and dependent quantization
(slice 2c: the rect search on the device, the MRL choice in mode_decide
and the trellis in the native recon core); and, slice 4a, translational P
and B pictures in the LDP, LDB and RA GOPs (`mode="ldp" | "ldb" | "ra"`):
the inter search of vvc_torch.enc.inter_search (csrc/me.cu), the DPB, the
collocated motion field, per-layer QP offsets and GOP-boundary
checkpoints; slice 4b adds affine ME (csrc/affine.cu), the MCTF pre-filter
of the temporal-layer-0 anchors (vvc_torch.enc.mctf) and the host inter
tools BDOF, DMVR, MMVD, CIIP, GPM, AMVR, SMVD and BCW.  The options of
later slices raise NotImplementedError naming their slice: LMCS and WPP
(2d), rate control.  The sharded encode (vvc_torch.shard.encode, slice 6)
runs the search over a mesh of ranks and hands it in as
`_precomputed_rdo`.  Everything after the search is the host code of vvc,
copied.

TPU-native analog of the reference's encoder stack
(`VTM/source/Lib/EncoderLib/EncLib.cpp` → EncLib::encode;
EncGOP.cpp → compressGOP (AI degenerate case); EncSlice.cpp →
compressSlice/encodeSlice; SEIEncoder.cpp → initDecodedPictureHashSEI +
libmd5).  Phases per picture (SURVEY.md §7.2 S2/S6):

  1. batched RDO on device (vvc_torch.enc.rdo) → partition + modes
  2. per tile (PPS tile columns — the primary spatial shard axis,
     SURVEY.md §2.7 P-3): sequential reconstruction (vvc_torch.model.recon,
     shared with the decoder) + host CABAC entropy into an independent
     substream.  Tiles cut all prediction/entropy dependencies, so both
     run concurrently across a thread pool (the native cores release the
     GIL); substreams are glued with entry-point offsets like the
     reference's tile bitstream layout.
  3. NAL framing (SPS/PPS/IDR slices + decoded-picture-hash SEI)
"""
from __future__ import annotations

import concurrent.futures
import hashlib
import os
import pickle

import numpy as np

from vvc_torch.common.types import NalUnitType, SliceType
from vvc_torch.io.nal import NalUnit, write_annexb
from vvc_torch.io.yuv import Frame, psnr
from vvc_torch.hls.ps import SPS, PPS, SliceHeader
from vvc_torch.hls.aps import write_aps_alf
from vvc_torch.hls.write import write_sps, write_pps, write_slice_header
from vvc_torch.packer import native as native_packer
from vvc_torch.cabac.ctx import SliceContexts
from vvc_torch.cabac.cu_syntax import TreeWriter
from vvc_torch.model.frame import CodingState
from vvc_torch.model.motion import motion_field_from_leaves
from vvc_torch.model.recon import reconstruct_leaves
from vvc_torch.kernels.alf import apply_alf_plane, apply_delta_gated
from vvc_torch.kernels.ccalf import apply_ccalf_delta, derive_ccalf
from vvc_torch.kernels.deblock import deblock_frame
from vvc_torch.kernels.sao import SAO_BO, SAO_EO, SAO_OFF, sao_filter_plane
from vvc_torch.enc.alf_enc import decide_alf_frame
from vvc_torch.enc.inter_search import rdo_inter_partition
from vvc_torch.enc.sao_enc import decide_sao_frame
from vvc_torch.utils.trace import active as _trace
from vvc_torch.enc.rdo import (rdo_partition, rdo_partition_dispatch,
                               rdo_partition_finish, rdo_partition_frames,
                               rdo_partition_tiled)
from vvc_torch.ops import resolve_device

SEI_PIC_HASH_MD5 = 132  # decoded_picture_hash payload type


def _not_in_slice(what: str, slice_name: str):
    return NotImplementedError(f"vvc_torch: {what} arrives with {slice_name}")


_SLICE_2D = "slice 2d (LMCS, WPP)"
_RATE_CONTROL = ("the rate-control item of ROADMAP queue 1 (host ratectrl "
                 "and the frame-batched search's chroma orders)")


def _check_sps(sps: SPS, pps: PPS) -> None:
    """Raise for every SPS/PPS option outside the ported slices."""
    for on, what in ((sps.lmcs, "LMCS"), (pps.wpp, "WPP row substreams")):
        if on:
            raise _not_in_slice(what, _SLICE_2D)


def _inter_tools(leaves, inter_cfg) -> dict:
    """Leaves of an inter picture by slice-4b tool: affine, MMVD, CIIP,
    GPM, BCW (a weight other than equal), AMVR (a coarser MVD tier), SMVD,
    and the bi leaves that DMVR/BDOF refine (`bdof_dmvr`; `dmvr_moved`
    where DMVR's mirrored search moved the MVs)."""
    from vvc_torch.kernels.mc import _bi_eligible
    refined = [l for l in leaves if l.pred == 1 and not l.affine
               and l.gpm is None and not (l.bcw != 2 and l.inter_dir == 3)
               and (inter_cfg.get("bdof") or inter_cfg.get("dmvr"))
               and _bi_eligible(l, inter_cfg)]
    return {"affine": sum(1 for l in leaves if l.affine),
            "mmvd": sum(1 for l in leaves if l.mmvd is not None),
            "ciip": sum(1 for l in leaves if l.ciip),
            "gpm": sum(1 for l in leaves if l.gpm is not None),
            "bcw": sum(1 for l in leaves if l.bcw != 2),
            "amvr": sum(1 for l in leaves if l.imv > 0),
            "smvd": sum(1 for l in leaves if l.smvd),
            "bdof_dmvr": len(refined),
            "dmvr_moved": sum(1 for l in refined
                              if getattr(l, "_dmvr_d", (0, 0)) != (0, 0))}


def _leaf_kinds(split_map, leaf_map, leaves) -> dict:
    """Leaves of a picture by kind (slice 2c's tools): rect, TT middle
    children, ISP, MRL, and the count of each W×H shape."""
    from vvc_torch.model.partition import SPLIT_TT_H, SPLIT_TT_V, child_blocks
    mids = sum(1 for (x, y, w, h), code in split_map.items()
               if code in (SPLIT_TT_H, SPLIT_TT_V)
               and child_blocks(x, y, w, h, code)[1] in leaf_map)
    shapes = {}
    for l in leaves:
        shapes[f"{l.w}x{l.h}"] = shapes.get(f"{l.w}x{l.h}", 0) + 1
    return {"rect": sum(1 for l in leaves if l.w != l.h), "tt_mid": mids,
            "isp": sum(1 for l in leaves if l.isp),
            "mrl": sum(1 for l in leaves if l.mrl), "shapes": shapes}


def _hash_sei_payload(planes, bit_depth: int = 8) -> bytes:
    out = bytearray([SEI_PIC_HASH_MD5])
    body = bytearray([0])  # hash_type 0 = MD5
    dt = np.uint8 if bit_depth == 8 else np.dtype("<u2")
    for p in planes:
        body += hashlib.md5(np.ascontiguousarray(p.astype(dt)).tobytes()).digest()
    out.append(len(body))
    out += body
    out += b"\x80"  # rbsp trailing
    return bytes(out)


def _decide_chroma_modes(leaves, frame, bit_depth: int):
    """Per-leaf DM-vs-CCLM decision on *original* samples (the same
    approximation the RDO search uses; reconstruction then executes the
    chosen mode exactly).  Reference: IntraSearch::estIntraPredChromaQT.

    DM costs come from one batched 67-mode prediction per (size, plane)
    group (vvc_torch.kernels.intra); CCLM costs from the vectorized model."""
    from vvc_torch.kernels.cclm import luma_ds_plane
    from vvc_torch.kernels.intra import (predict_modes_np,
                                         build_ref_lines_orig_np)

    ds = luma_ds_plane(frame.y)
    by_size = {}
    for i, leaf in enumerate(leaves):
        by_size.setdefault(leaf.size >> 1, []).append(i)
    by_size = {k: np.asarray(v) for k, v in by_size.items()}
    cost_dm = np.zeros(len(leaves))
    cost_lm = {v: np.zeros(len(leaves)) for v in (1, 2, 3)}
    from vvc_torch.kernels.cclm import derive_models_batch

    for cs, idxs in by_size.items():
        xs = np.array([leaves[i].x0 >> 1 for i in idxs], dtype=np.int32)
        ys = np.array([leaves[i].y0 >> 1 for i in idxs], dtype=np.int32)
        modes = np.array([leaves[i].luma_mode for i in idxs])
        modes = np.where(modes >= 67, 0, modes)  # MIP leaves: DM = planar
        oy = np.arange(cs)
        # batched block extraction [N, cs, cs]
        ds_blocks = ds[ys[:, None, None] + oy[None, :, None],
                       xs[:, None, None] + oy[None, None, :]].astype(np.int64)
        for plane in (frame.cb, frame.cr):
            refs = build_ref_lines_orig_np(plane, xs, ys, cs, bit_depth)
            pdm = predict_modes_np(refs, modes, cs, bit_depth)
            obs = plane[ys[:, None, None] + oy[None, :, None],
                        xs[:, None, None] + oy[None, None, :]].astype(np.int64)
            cost_dm[idxs] += ((obs - pdm) ** 2).sum(axis=(1, 2))
            for v in (1, 2, 3):   # LM, LM_L, LM_T
                ab = derive_models_batch(ds, plane, xs, ys, cs, bit_depth,
                                         variant=v)
                plm = (((ab[:, 0:1, None] * ds_blocks) >> 13)
                       + ab[:, 1:2, None])
                plm = np.clip(plm, 0, (1 << bit_depth) - 1)
                cost_lm[v][idxs] += ((obs - plm) ** 2).sum(axis=(1, 2))
    for i, leaf in enumerate(leaves):
        costs = [cost_dm[i], cost_lm[1][i], cost_lm[2][i], cost_lm[3][i]]
        leaf.chroma_mode = int(np.argmin(costs))


def tile_columns(num_cols: int, width: int, ctu_size: int):
    """Uniform tile column bounds in luma samples (reference: PPS::initTiles
    uniform spacing).  Returns [(x0, x1), ...]."""
    n_ctu = (width + ctu_size - 1) // ctu_size
    bounds = [(i * n_ctu) // num_cols * ctu_size for i in range(num_cols)]
    bounds.append(width)
    return [(bounds[i], min(bounds[i + 1], width)) for i in range(num_cols)
            if bounds[i] < width]


def tile_grid(num_cols: int, num_rows: int, width: int, height: int,
              ctu_size: int):
    """Uniform tile grid, raster order (reference: PPS::initTiles rows ×
    columns).  Returns [(x0, x1, y0, y1), ...]."""
    cols = tile_columns(num_cols, width, ctu_size)
    rows = tile_columns(num_rows, height, ctu_size)
    return [(tx0, tx1, ty0, ty1) for ty0, ty1 in rows
            for tx0, tx1 in cols]


class Encoder:
    def __init__(self, sps: SPS, pps: PPS, parallel_tiles: bool = True,
                 device=None):
        self.sps = sps
        self.pps = pps
        self.parallel_tiles = parallel_tiles
        self.device = resolve_device(device)

    def _recon_tile(self, frame, recon, leaves_t, qp, refs=None,
                    inter_cfg=None):
        """Decision pass + pure-execution reconstruction for one tile
        (tiles cut all prediction/entropy dependencies, so each call is
        self-contained and parallel).  refs: the (l0, l1) lists of (y, cb,
        cr) reference planes of an inter slice."""
        from vvc_torch.enc.mode_decide import decide_modes
        from vvc_torch.utils import perf
        sps = self.sps
        with perf.phase("recon_decide"):
            preds = decide_modes(leaves_t, (frame.y, frame.cb, frame.cr),
                                 qp, sps.bit_depth, sps,
                                 inter_cfg=inter_cfg, refs=refs)
        with perf.phase("recon_exec"):
            reconstruct_leaves(leaves_t, recon, qp, sps.bit_depth,
                               orig_planes=(frame.y, frame.cb, frame.cr),
                               lossless=sps.lossless, refs=refs,
                               dep_quant=sps.dep_quant,
                               inter_cfg=inter_cfg,
                               pred_cache=preds if preds else None)

    def _entropy_tile_native(self, leaves_t, size_map, tx0, tx1, qp,
                             sao_ser):
        """Native C++ tree-syntax writer (intra slices): one call per tile
        (vvc_torch/packer/cabac_core.cpp tw_write), as vvc's encoder does;
        sao_ser: the serialized SAO parameters or None."""
        sps = self.sps
        ctxs = SliceContexts(qp)
        enc = native_packer.NativeBinEncoder(ctxs)
        recs, levels = native_packer.serialize_leaves(leaves_t)
        tw = native_packer.NativeTreeWriter(
            min(tx1, sps.width), sps.height, sps.ctu_size, sps.min_cu_size,
            mts=sps.mts_intra, cclm=sps.cclm, mip=sps.mip, lfnst=sps.lfnst)
        sao_arr, stride = sao_ser if sao_ser is not None else (None, 0)
        tw.write(enc, ctxs, size_map, recs, levels, sao_arr, stride,
                 tx0, tx1, 0, sps.height, tx0)
        enc.encode_bin_trm(1)
        return enc.finish()

    def _entropy_tile(self, split_map, leaf_map, tx0, tx1, qp, sao_params,
                      slice_type=SliceType.I, n_ref=(0, 0),
                      col_info=(None, 0, ((), ())), ty0=0, ty1=None):
        from vvc_torch.cabac.sao_syntax import write_sao_params
        from vvc_torch.model.motion import MotionState
        sps = self.sps
        ctxs = SliceContexts(qp)
        enc = native_packer.NativeBinEncoder(ctxs)
        state = CodingState(sps.width, sps.height)
        writer = TreeWriter(enc, ctxs, state, min(tx1, sps.width), sps.height,
                            split_map, leaf_map, sps.ctu_size,
                            sps.min_cu_size, mts_enabled=sps.mts_intra,
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
                            slice_type=int(slice_type),
                            mstate=MotionState(sps.width, sps.height),
                            n_ref=n_ref, col=col_info[0],
                            cur_poc=col_info[1], ref_pocs=col_info[2])
        if ty1 is None:
            ty1 = sps.height
        for cy in range(ty0, ty1, sps.ctu_size):
            for cx in range(tx0, tx1, sps.ctu_size):
                if sao_params is not None:
                    cs = sps.ctu_size
                    write_sao_params(
                        enc, ctxs, sao_params[(cx, cy)],
                        left=(sao_params.get((cx - cs, cy))
                              if cx - cs >= tx0 else None),
                        up=(sao_params.get((cx, cy - cs))
                            if cy - cs >= ty0 else None))
                writer.write_ctu(cx, cy)
        enc.encode_bin_trm(1)
        return enc.finish()

    def _alf(self, frame, recon, qp):
        """ALF decision and apply, then CC-ALF for Cb and Cr, in place on
        recon (vvc/enc/encoder.py:446-473).  Returns the slice's ALF
        parameters (luma, CTU flag list, chroma, cc_cb, cc_cr)."""
        sps = self.sps
        bd = sps.bit_depth
        luma_c, flags, chroma_c, luma_delta = decide_alf_frame(
            (frame.y, frame.cb, frame.cr), recon, qp, bd, sps.ctu_size,
            device=self.device)
        flag_list = [flags[(x0, y0)]
                     for y0 in range(0, sps.height, sps.ctu_size)
                     for x0 in range(0, sps.width, sps.ctu_size)]
        if luma_c is not None:
            apply_delta_gated(recon[0], luma_delta, bd, flags, sps.ctu_size)
        if chroma_c is not None:
            apply_alf_plane(recon[1], chroma_c, 2, bd)
            apply_alf_plane(recon[2], chroma_c, 2, bd)
        # CC-ALF: additive chroma correction filtered from the final luma
        # (reference: applyCcAlfFilter; vvc_torch.kernels.ccalf)
        cc_cb = derive_ccalf(frame.cb, recon[1], recon[0], bd)
        if cc_cb is not None:
            recon[1][:] = apply_ccalf_delta(recon[1], recon[0], cc_cb, bd)
        cc_cr = derive_ccalf(frame.cr, recon[2], recon[0], bd)
        if cc_cr is not None:
            recon[2][:] = apply_ccalf_delta(recon[2], recon[0], cc_cr, bd)
        return (luma_c, flag_list if luma_c is not None else None,
                chroma_c, cc_cb, cc_cr)

    def encode_frame(self, frame: Frame, poc: int, rdo_result=None,
                     slice_type=SliceType.I, refs_l0=(), refs_l1=(),
                     qp=None, col=None, retained_pocs=()):
        """Returns (nal_units, recon Frame, stats dict).

        rdo_result: optional precomputed (split_map, leaf_map, leaves) from
        the batched search (rdo_partition_frames / the AI pipeline).
        refs_l0/refs_l1: [(poc, Frame), ...] reference pictures (filtered
        reconstructions, nearest first) for P/B slices; col: the
        collocated motion field (TMVP); retained_pocs: pictures the DPB
        keeps beyond the reference lists."""
        sps, pps = self.sps, self.pps
        _check_sps(sps, pps)
        qp = pps.init_qp if qp is None else qp
        bd = sps.bit_depth
        inter_slice = slice_type != SliceType.I
        n_ref = (len(refs_l0), len(refs_l1))
        ref_planes = ([(f.y, f.cb, f.cr) for _, f in refs_l0],
                      [(f.y, f.cb, f.cr) for _, f in refs_l1])

        from vvc_torch.utils import perf
        # with CCLM the intra searches decide each leaf's chroma mode on
        # the device; the inter search decides luma only, and the host
        # decides the chroma of its intra leaves (_decide_chroma_modes)
        chroma = (frame.cb, frame.cr) if sps.cclm else None
        chroma_on_device = sps.cclm
        if rdo_result is not None:
            split_map, leaf_map, leaves = rdo_result
        elif inter_slice:
            with perf.phase("search_inter"):
                split_map, leaf_map, leaves = rdo_inter_partition(
                    frame.y, [f.y for _, f in refs_l0],
                    [f.y for _, f in refs_l1],
                    qp, bd, sps.ctu_size, sps.min_cu_size,
                    is_b=slice_type == SliceType.B, affine=sps.affine,
                    device=self.device)
            chroma_on_device = False
        elif pps.num_tile_cols > 1:
            # per-tile search: prediction references clamp at tile edges,
            # matching the tile reconstruction's availability
            split_map, leaf_map, leaves = rdo_partition_tiled(
                frame.y, tile_columns(pps.num_tile_cols, sps.width,
                                      sps.ctu_size),
                qp, bd, sps.ctu_size, sps.min_cu_size,
                lossless=sps.lossless, lfnst=sps.lfnst, chroma_planes=chroma,
                mtt=sps.max_mtt_depth_intra > 0, isp=sps.isp,
                device=self.device)
        else:
            split_map, leaf_map, leaves = rdo_partition(
                frame.y, qp, bd, sps.ctu_size, sps.min_cu_size,
                lossless=sps.lossless, lfnst=sps.lfnst, chroma_planes=chroma,
                mtt=sps.max_mtt_depth_intra > 0, isp=sps.isp,
                device=self.device)
        if sps.cclm and not chroma_on_device:
            intra_leaves = [l for l in leaves if l.pred == 0]
            if intra_leaves:
                _decide_chroma_modes(intra_leaves, frame, bd)

        cols = tile_columns(pps.num_tile_cols, sps.width, sps.ctu_size)
        rows = tile_columns(pps.num_tile_rows, sps.height, sps.ctu_size)
        tiles = tile_grid(pps.num_tile_cols, pps.num_tile_rows, sps.width,
                          sps.height, sps.ctu_size)
        recon = (np.zeros_like(frame.y), np.zeros_like(frame.cb),
                 np.zeros_like(frame.cr))
        leaves_per_tile = [[l for l in leaves
                            if tx0 <= l.x0 < tx1 and ty0 <= l.y0 < ty1]
                           for tx0, tx1, ty0, ty1 in tiles]

        # phase 1: reconstruction per tile (availability maps are per-call,
        # so tiles are isolated and parallel)
        inter_cfg = None
        if inter_slice:
            inter_cfg = {"bdof": sps.bdof, "dmvr": sps.dmvr, "cur_poc": poc,
                         "ref_pocs": (tuple(p for p, _ in refs_l0),
                                      tuple(p for p, _ in refs_l1)),
                         "ciip": sps.ciip, "gpm": sps.gpm, "bcw": sps.bcw,
                         "col": col, "n_ref": n_ref,
                         "is_b": slice_type == SliceType.B}

        def recon_tile(i):
            self._recon_tile(frame, recon, leaves_per_tile[i], qp,
                             refs=ref_planes if inter_slice else None,
                             inter_cfg=inter_cfg)

        with perf.phase("recon"):
            if self.parallel_tiles and len(tiles) > 1:
                with concurrent.futures.ThreadPoolExecutor(len(tiles)) as ex:
                    list(ex.map(recon_tile, range(len(tiles))))
            else:
                for i in range(len(tiles)):
                    recon_tile(i)

        # phase 2: in-loop filters in the reference order: deblock → SAO →
        # ALF → CC-ALF (lossless has none)
        sao_params = alf_hdr = None
        with perf.phase("filters"):
            if sps.deblocking and not sps.lossless:
                with perf.phase("filt_deblock"):
                    deblock_frame(recon, leaves, qp, bd,
                                  tile_x_bounds=tuple(t[0] for t in cols[1:]),
                                  tile_y_bounds=tuple(t[0] for t in rows[1:]))
            if sps.sao and not sps.lossless:
                with perf.phase("filt_sao"):
                    sao_params = decide_sao_frame(
                        (frame.y, frame.cb, frame.cr), recon, qp, bd,
                        sps.ctu_size, tiles, device=self.device)
                    for comp in range(3):
                        per_comp = {k: v[comp] for k, v in sao_params.items()}
                        sao_filter_plane(recon[comp], per_comp, sps.ctu_size,
                                         bd, tiles,
                                         comp_scale=0 if comp == 0 else 1)
            if sps.alf and not sps.lossless:
                with perf.phase("filt_alf"):
                    alf_hdr = self._alf(frame, recon, qp)

        # phase 3: entropy per tile (parallel).  As in vvc, lossy intra
        # slices run the native C++ tree writer; inter slices, lossless,
        # MTT, ISP, MRL, other CTU sizes, tile rows and tracing the Python
        # TreeWriter.
        col_info = (col, poc, (tuple(p for p, _ in refs_l0),
                               tuple(p for p, _ in refs_l1)))
        use_native = (not inter_slice and sps.ctu_size == 64
                      and sps.max_mtt_depth_intra == 0
                      and pps.num_tile_rows == 1
                      and not sps.isp and not sps.mrl
                      and not sps.lossless and not _trace().enabled)
        if use_native:
            size_map = native_packer.build_size_map(
                leaves, sps.width, sps.height, sps.min_cu_size)
            sao_ser = (native_packer.serialize_sao(
                sao_params, sps.width, sps.height, sps.ctu_size)
                if sao_params is not None else None)

        def entropy_tile(i):
            tx0, tx1, ty0, ty1 = tiles[i]
            if use_native:
                return self._entropy_tile_native(
                    leaves_per_tile[i], size_map, tx0, tx1, qp, sao_ser)
            return self._entropy_tile(split_map, leaf_map, tx0, tx1, qp,
                                      sao_params, slice_type, n_ref,
                                      col_info, ty0=ty0, ty1=ty1)

        with perf.phase("entropy"):
            if self.parallel_tiles and len(tiles) > 1:
                with concurrent.futures.ThreadPoolExecutor(len(tiles)) as ex:
                    substreams = list(ex.map(entropy_tile, range(len(tiles))))
            else:
                substreams = [entropy_tile(i) for i in range(len(tiles))]

        sh = SliceHeader(pps.pps_id, int(slice_type), poc, qp,
                         l0_deltas=tuple(poc - p for p, _ in refs_l0),
                         l1_deltas=tuple(poc - p for p, _ in refs_l1),
                         retained_deltas=tuple(poc - p
                                               for p in retained_pocs))
        # ALF parameters ride an APS NAL ahead of the slice (reference:
        # EncGOP xWriteAPS; ids cycle per picture like the reference's ALF
        # APS pool)
        aps_nals = []
        alf_aps_id = 0
        alf_sh = None
        if alf_hdr is not None:
            luma_c, flag_list, chroma_c, cc_cb, cc_cr = alf_hdr
            if (luma_c is not None or chroma_c is not None
                    or cc_cb is not None or cc_cr is not None):
                alf_aps_id = poc % 32
                aps_nals.append(NalUnit(NalUnitType.PREFIX_APS,
                                        write_aps_alf(alf_aps_id, luma_c,
                                                      chroma_c, cc_cb,
                                                      cc_cr)))
            alf_sh = (luma_c is not None or None, flag_list,
                      (chroma_c is not None or cc_cb is not None
                       or cc_cr is not None) or None)
        header = write_slice_header(sh, pps.init_qp,
                                    entry_sizes=[len(s) for s in substreams],
                                    alf=alf_sh if sps.alf else None,
                                    lmcs_enabled=sps.lmcs,
                                    alf_aps_id=alf_aps_id)
        slice_rbsp = header + b"".join(substreams)
        nal_type = (NalUnitType.IDR_N_LP if slice_type == SliceType.I
                    else NalUnitType.TRAIL)
        nals = aps_nals + [
            NalUnit(nal_type, slice_rbsp),
            NalUnit(NalUnitType.SUFFIX_SEI, _hash_sei_payload(recon, bd))]
        rec_frame = Frame(*recon, bd)
        self.last_leaves = leaves
        stats = {
            "bits": sum(8 * (len(n.payload) + 2) for n in nals),
            "psnr_y": psnr(frame.y, recon[0], bd),
            "psnr_cb": psnr(frame.cb, recon[1], bd),
            "psnr_cr": psnr(frame.cr, recon[2], bd),
            "n_cu": len(leaves),
            "n_tiles": len(tiles),
            # leaves by prediction: intra, then inter_dir 1 (L0), 2 (L1),
            # 3 (bi)
            "leaf_dirs": [sum(l.pred == 0 for l in leaves)]
            + [sum(l.pred == 1 and l.inter_dir == d for l in leaves)
               for d in (1, 2, 3)],
        }
        if sps.max_mtt_depth_intra > 0 or sps.isp or sps.mrl:
            stats["leaf_kinds"] = _leaf_kinds(split_map, leaf_map, leaves)
        if inter_slice:
            stats["inter_tools"] = _inter_tools(leaves, inter_cfg)
        if sao_params is not None:
            # CTUs per SAO type (OFF, BO, EO) for Y, Cb, Cr
            stats["sao_types"] = [
                [sum(p[c].mode == m for p in sao_params.values())
                 for m in (SAO_OFF, SAO_BO, SAO_EO)] for c in range(3)]
        if alf_hdr is not None:
            luma_c, flag_list, chroma_c, cc_cb, cc_cr = alf_hdr
            stats["alf"] = {
                "luma_filters": 0 if luma_c is None else len(luma_c[0]),
                "ctu_on": sum(flag_list) if flag_list else 0,
                "chroma": chroma_c is not None,
                "ccalf_cb": cc_cb is not None, "ccalf_cr": cc_cr is not None}
        return nals, rec_frame, stats


def encode_sequence(frames, qp: int = 32, bit_depth: int = 8,
                    ctu_size: int = 64,
                    num_tile_cols: int = 1, num_tile_rows: int = 1,
                    lossless: bool = False,
                    parallel_tiles: bool = True, wpp: bool = False,
                    lmcs: bool = False, mode: str = "ai",
                    gop_size: int = 16, intra_period: int = -1,
                    target_kbps: float = 0.0, fps: float = 30.0,
                    dep_quant: bool = False, mctf: bool = False,
                    bdof: bool = False, dmvr: bool = False,
                    mtt: bool = False, isp: bool = False,
                    affine: bool = False, mmvd: bool = False,
                    ciip: bool = False, gpm: bool = False,
                    mrl: bool = False, amvr: bool = False,
                    smvd: bool = False, bcw: bool = False,
                    poc_base: int = 0, _precomputed_rdo=None,
                    checkpoint_path: str | None = None,
                    resume: bool = False, device=None):
    """Encode frames (list of Frame) → (annexb bytes, recons, stats).

    Same signature as vvc.enc.encoder.encode_sequence plus `device`:
    None = CUDA (raises when CUDA is absent), "cpu" = the plain PyTorch
    path.  mode: "ai" (all-intra), "ldp" (low-delay P), "ldb" (low-delay
    B), "ra" (random access hierarchical B) — reference:
    EncGOP::compressGOP GOP structures.  It runs vvc's default lossy tool
    set (MTS, MIP, LFNST, CCLM, deblocking, SAO, ALF, CC-ALF; lossless AI
    too) with inter, MTT, ISP, MRL and dependent quantization (mtt=,
    isp=, mrl=, dep_quant=) and the inter tools affine=, mctf=, bdof=,
    dmvr=, mmvd=, ciip=, gpm=, amvr=, smvd=, bcw=; the options of slice 2d
    (LMCS, WPP) and rate control raise NotImplementedError naming the
    slice that brings them.  _precomputed_rdo: per-frame search results
    from the sharded encode (vvc_torch.shard.encode), which this call only
    reconstructs and entropy-codes.
    recons/stats are returned in display (POC) order.
    checkpoint_path: encoder state (DPB recons, NALs so far) is written
    there after each temporal-layer-0 anchor; resume=True continues an
    interrupted encode from it, byte-identical to an uninterrupted run.
    poc_base: slice-header POC offset."""
    from vvc_torch.enc.gop import gop_order

    if wpp:
        raise _not_in_slice("WPP row substreams", _SLICE_2D)
    if target_kbps > 0:
        raise _not_in_slice("rate control", _RATE_CONTROL)
    h, w = frames[0].y.shape
    sps = SPS(width=w, height=h, bit_depth=bit_depth, ctu_size=ctu_size,
              deblocking=not lossless, mts_intra=not lossless,
              mip=not lossless, lfnst=not lossless,
              sao=not lossless, alf=not lossless, cclm=not lossless,
              lmcs=lmcs and not lossless, lossless=lossless,
              max_mtt_depth_intra=2 if (mtt and not lossless) else 0,
              isp=isp and not lossless,
              dep_quant=dep_quant and not lossless,
              bdof=bdof and mode == "ra", dmvr=dmvr and mode == "ra",
              affine=affine and mode != "ai" and not lossless,
              mmvd=mmvd and mode != "ai" and not lossless,
              ciip=ciip and mode != "ai" and not lossless,
              gpm=gpm and mode == "ra" and not lossless,
              mrl=mrl and not lossless,
              amvr=amvr and mode != "ai" and not lossless,
              smvd=smvd and mode == "ra" and not lossless,
              bcw=bcw and mode == "ra" and not lossless)
    pps = PPS(init_qp=qp, num_tile_cols=num_tile_cols,
              num_tile_rows=num_tile_rows, wpp=wpp)
    _check_sps(sps, pps)
    enc = Encoder(sps, pps, parallel_tiles, device)
    nals = [NalUnit(NalUnitType.SPS, write_sps(sps)),
            NalUnit(NalUnitType.PPS, write_pps(pps))]
    recons = [None] * len(frames)
    stats = [None] * len(frames)
    order = gop_order(len(frames), mode, gop_size, intra_period)

    if (mode == "ai" and num_tile_cols == 1 and not lmcs
            and _precomputed_rdo is None):
        # AI pipeline: every frame's search is queued on the device first
        # (asynchronous launches); a host thread pool then runs transfer +
        # DP, recon and entropy per frame (frames are independent; the
        # native cores release the GIL).
        handles = [rdo_partition_dispatch(
            f.y, qp, bit_depth, sps.ctu_size, sps.min_cu_size,
            lossless=lossless, lfnst=sps.lfnst,
            chroma_planes=(f.cb, f.cr) if sps.cclm else None,
            mtt=sps.max_mtt_depth_intra > 0, isp=sps.isp, device=enc.device)
            for f in frames]

        def do_frame(poc):
            rdo_result = rdo_partition_finish(handles[poc])
            return enc.encode_frame(frames[poc], poc + poc_base, rdo_result,
                                    slice_type=SliceType.I)

        with concurrent.futures.ThreadPoolExecutor(4) as ex:
            results = list(ex.map(do_frame, range(len(frames))))
        for poc, (n, r, s) in enumerate(results):
            nals += n
            recons[poc] = r
            s["slice_type"] = int(SliceType.I)
            s["poc"] = poc
            s["qp"] = qp
            stats[poc] = s
        return write_annexb(nals), recons, stats

    if _precomputed_rdo is not None:
        # sharded path (vvc_torch.shard.encode): the per-(frame, tile)
        # search already ran on the mesh; this call only assembles recon,
        # entropy and NALs
        rdo_results = _precomputed_rdo
    elif mode == "ai" and num_tile_cols == 1:
        # one device search for the whole sequence; host recon/entropy
        # then proceeds per frame
        rdo_results = rdo_partition_frames(
            [f.y for f in frames], qp, bit_depth, sps.ctu_size,
            sps.min_cu_size, lossless=lossless, lfnst=sps.lfnst,
            chroma_planes=(([f.cb for f in frames], [f.cr for f in frames])
                           if sps.cclm else None),
            mtt=sps.max_mtt_depth_intra > 0, isp=sps.isp, device=enc.device)
    else:
        rdo_results = None   # per-picture search inside encode_frame

    dpb = {}   # poc -> filtered recon Frame (reference: DecLib m_cListPic)
    col_dpb = {}  # poc -> ColMotion for TMVP
    # reference marking: a picture stays in the DPB only while a
    # not-yet-coded entry references it (reference:
    # Slice::applyReferencePictureListBasedMarking)
    needed_after = []
    fut = set()
    for e in reversed(order):
        needed_after.append(frozenset(fut))
        fut.update(e.l0)
        fut.update(e.l1)
    needed_after.reverse()
    start_ei = 0
    ck_key = (len(frames), qp, mode, gop_size, intra_period, target_kbps,
              poc_base, w, h, bit_depth)
    if resume and checkpoint_path and os.path.exists(checkpoint_path):
        with open(checkpoint_path, "rb") as fh:
            ck = pickle.load(fh)
        assert ck["key"] == ck_key, "checkpoint/config mismatch"
        start_ei = ck["next_ei"]
        nals = ck["nals"]
        dpb = ck["dpb"]
        col_dpb = ck["col_dpb"]
        for p, r in ck["recons"].items():
            recons[p] = r
        for p, st_ in ck["stats"].items():
            stats[p] = st_
    for ei, e in enumerate(order):
        if ei < start_ei:
            continue
        f = frames[e.poc]
        if mctf and mode != "ai" and e.tid == 0 and len(frames) > 1:
            # MCTF pre-filter on temporal-layer-0 anchors (reference:
            # EncTemporalFilter applied in EncLib::encodePrep)
            from vvc_torch.enc.mctf import mctf_filter
            from vvc_torch.utils import perf
            with perf.phase("mctf"):
                f = mctf_filter(frames, e.poc, qp, bit_depth,
                                device=enc.device)
        refs_l0 = [(p + poc_base, dpb[p]) for p in e.l0]
        refs_l1 = [(p + poc_base, dpb[p]) for p in e.l1]
        # collocated picture: L1[0] for B, L0[0] for P (reference:
        # Slice::setColFromL0Flag default)
        col = None
        if e.slice_type == SliceType.B and e.l1:
            col = col_dpb.get(e.l1[0])
        elif e.slice_type == SliceType.P and e.l0:
            col = col_dpb.get(e.l0[0])
        pic_qp = min(63, qp + e.qp_offset)
        n, r, s = enc.encode_frame(
            f, e.poc + poc_base,
            rdo_results[e.poc] if rdo_results is not None else None,
            slice_type=e.slice_type, refs_l0=refs_l0, refs_l1=refs_l1,
            qp=pic_qp, col=col,
            retained_pocs=tuple(p + poc_base
                                for p in sorted(needed_after[ei])))
        col_dpb[e.poc] = motion_field_from_leaves(
            enc.last_leaves, w, h, e.poc + poc_base,
            (tuple(p + poc_base for p in e.l0),
             tuple(p + poc_base for p in e.l1)))
        nals += n
        dpb[e.poc] = r
        recons[e.poc] = r
        s["slice_type"] = int(e.slice_type)
        s["poc"] = e.poc
        s["qp"] = pic_qp
        stats[e.poc] = s
        # DPB bump: drop pictures no future entry references
        for p in [p for p in dpb if p not in needed_after[ei]]:
            del dpb[p]
            col_dpb.pop(p, None)
        if (checkpoint_path and ei + 1 < len(order)
                and order[ei + 1].tid == 0):
            with open(checkpoint_path + ".tmp", "wb") as fh:
                pickle.dump({"key": ck_key, "next_ei": ei + 1,
                             "nals": nals, "dpb": dpb,
                             "col_dpb": col_dpb, "rc": None,
                             "recons": {p: r for p, r in enumerate(recons)
                                        if r is not None},
                             "stats": {p: st_ for p, st_ in enumerate(stats)
                                       if st_ is not None}}, fh)
            os.replace(checkpoint_path + ".tmp", checkpoint_path)
    return write_annexb(nals), recons, stats

"""Sequential z-order reconstruction — the single code path shared by the
encoder (which also derives quantized levels here) and the decoder.

TPU-native analog of the reference's reconstruction drivers
(`VTM/source/Lib/DecoderLib/DecCu.cpp` → xReconIntraQT /
xIntraRecBlk; encoder side IntraSearch::xIntraCodingTUBlock).  Keeping one
implementation enforces the CommonLib invariant (SURVEY.md §1.1): the
encoder's reconstruction IS the decoder's output, so
decode(encode(x)) == encoder_recon holds bit-exactly by construction.

This is the intentionally-serial path (intra prediction consumes
reconstructed neighbours).  The batched wavefront (lax.scan over CTU
anti-diagonals, SURVEY.md §7.3 item 3) replaces the inner loop in a later
stage; the kernels called here are the same ones the batch path uses.
"""
from __future__ import annotations

import numpy as np

from vvc_torch.kernels.intra import build_ref_line, predict_intra
from vvc_torch.kernels.transform import fwd_transform_np, inv_transform_np
from vvc_torch.kernels.quant import quant_np, dequant_np


_CHROMA_QP_MAP = {30: 29, 31: 30, 32: 31, 33: 32, 34: 33, 35: 33, 36: 34,
                  37: 34, 38: 35, 39: 35, 40: 36, 41: 36, 42: 37, 43: 37}


def chroma_qp(qp: int) -> int:
    """Luma→chroma QP mapping (default ChromaQpTable shape for 4:2:0:
    identity below 30, compressed 30..43, qp−6 above; reference: Slice.h →
    ChromaQpMappingTable).  [verify] exact VVC default entries."""
    qp = min(qp, 63)
    if qp < 30:
        return qp
    if qp in _CHROMA_QP_MAP:
        return _CHROMA_QP_MAP[qp]
    return qp - 6


def _recon_block(plane, orig, coded, x0, y0, size, mode, qp, bit_depth, levels,
                 tr_h=0, tr_v=0, lossless=False, cclm_ds=None, pred=None,
                 intra=True, dep_quant=False, lfnst=0, h=None,
                 chroma_scale=None, bdpcm=0, mrl=0):
    """Predict + (inverse-)transform one block in `plane`.

    If `levels` is None (encode), derives them from `orig`; returns levels.
    Lossless (transquant bypass): levels ARE the residual — exact recon.
    cclm_ds: downsampled-luma plane → CCLM prediction instead of `mode`.
    pred: externally computed prediction (inter MC) — skips intra predict.
    h: block height when rectangular (MTT leaves); default square.
    chroma_scale: optional (fwd_s, inv_s) LMCS chroma residual scales
    (1<<11 fixed point, reference Reshape chroma scaling): fwd multiplies
    the residual before the forward transform (encode), inv after the
    inverse transform (both sides — shared recon keeps them bit-equal).
    """
    w = size
    h = w if h is None else h
    if pred is None:
        if cclm_ds is not None:
            from vvc_torch.kernels.cclm import predict_cclm
            assert w == h, "CCLM gated to square leaves"
            ds, variant = cclm_ds
            pred = predict_cclm(ds, plane, coded, x0, y0, size, bit_depth,
                                variant=variant)
        elif w == h:
            if mrl:
                from vvc_torch.kernels.intra import build_ref_line_mrl
                c = build_ref_line_mrl(plane, coded, x0, y0, size,
                                       bit_depth, mrl)
            else:
                c = build_ref_line(plane, coded, x0, y0, size, bit_depth)
            pred = predict_intra(c, mode, size, bit_depth)
        else:
            from vvc_torch.kernels.intra import (build_ref_line_rect,
                                           predict_intra_rect)
            c = build_ref_line_rect(plane, coded, x0, y0, w, h, bit_depth)
            pred = predict_intra_rect(c, mode, w, h, bit_depth)
    if levels is None:
        resi = orig[y0:y0 + h, x0:x0 + w].astype(np.int32) - pred
        if lossless:
            # TS lossless: 1-step quant → levels ARE the residual; BDPCM
            # codes quantized-residual DPCM deltas along the prediction
            # direction (spec 8.4.5.2 intra_bdpcm)
            levels = _dpcm_fwd(resi, bdpcm) if bdpcm else resi.copy()
        else:
            if chroma_scale is not None:
                resi = (resi * chroma_scale[0] + (1 << 10)) >> 11
            coeff = fwd_transform_np(resi, bit_depth, tr_h, tr_v)
            if lfnst:
                from vvc_torch.kernels.lfnst import fwd_lfnst_np
                coeff = fwd_lfnst_np(coeff, mode, lfnst)
            if dep_quant:
                from vvc_torch.kernels.depquant import quant_depquant_np
                levels = quant_depquant_np(coeff, qp, bit_depth)
            else:
                levels = quant_np(coeff, qp, bit_depth, intra=intra)
    if np.any(levels):
        if lossless:
            rec_resi = _dpcm_inv(levels, bdpcm) if bdpcm else levels
        else:
            if dep_quant:
                from vvc_torch.kernels.depquant import dequant_depquant_np
                deq = dequant_depquant_np(levels, qp, bit_depth)
            else:
                deq = dequant_np(levels, qp, bit_depth)
            if lfnst:
                from vvc_torch.kernels.lfnst import inv_lfnst_np
                deq = inv_lfnst_np(deq, mode, lfnst)
            rec_resi = inv_transform_np(deq, bit_depth, tr_h, tr_v)
            if chroma_scale is not None:
                rec_resi = ((rec_resi.astype(np.int64) * chroma_scale[1]
                             + (1 << 10)) >> 11).astype(np.int32)
        rec = np.clip(pred + rec_resi, 0, (1 << bit_depth) - 1)
    else:
        rec = pred
    plane[y0:y0 + h, x0:x0 + w] = rec
    return levels


def _dpcm_fwd(resi: np.ndarray, bdpcm: int) -> np.ndarray:
    """BDPCM delta coding: 1 = horizontal (delta along x), 2 = vertical."""
    out = resi.copy()
    if bdpcm == 1:
        out[:, 1:] = resi[:, 1:] - resi[:, :-1]
    else:
        out[1:, :] = resi[1:, :] - resi[:-1, :]
    return out


def _dpcm_inv(levels: np.ndarray, bdpcm: int) -> np.ndarray:
    axis = 1 if bdpcm == 1 else 0
    return np.cumsum(levels, axis=axis, dtype=np.int64).astype(np.int32)


def _decide_bdpcm(plane, orig, coded, x0, y0, w, h, mode, bit_depth):
    """Encoder BDPCM decision for one lossless intra CU: try {off, H, V}
    by summed log2(1+|level|) (level-rate proxy) and return (bdpcm,
    effective mode).  Predictions come from the recon plane like the real
    recon — in lossless recon == source, so this is exact (reference:
    EncCu BDPCM RD loop via xCheckRDCostIntra)."""
    from vvc_torch.kernels.intra import build_ref_line, predict_intra

    def cost(lv):
        return float(np.log2(1.0 + np.abs(lv)).sum())

    c = build_ref_line(plane, coded, x0, y0, w, bit_depth)
    tgt = orig[y0:y0 + h, x0:x0 + w].astype(np.int32)
    best = (cost(tgt - predict_intra(c, mode, w, bit_depth)), 0, mode)
    for bd_dir, bmode in ((1, 18), (2, 50)):
        resi = tgt - predict_intra(c, bmode, w, bit_depth)
        cc = cost(_dpcm_fwd(resi, bd_dir))
        if cc < best[0]:
            best = (cc, bd_dir, bmode)
    return best[1], best[2]


def reconstruct_leaves(leaves, recon_planes, qp: int, bit_depth: int = 8,
                       orig_planes=None, use_native: bool = True,
                       lossless: bool = False, refs=None,
                       dep_quant: bool = False, inter_cfg=None,
                       lmcs_chroma=None, pred_cache=None,
                       lmcs_fwd_lut=None):
    """Reconstruct all leaves in z-order into recon_planes (y, cb, cr).

    Encoder mode: orig_planes given, leaf.lev_* are None → derives and
    stores levels on each leaf.  Decoder mode: leaf.lev_* already parsed.
    Availability maps are (re)built here so they always reflect recon
    progress, independent of any syntax-phase state.

    PURE EXECUTION: every mode decision (CIIP/GPM/BCW/MRL, merge
    matching) is already on the leaf — the encoder's vvc_torch.enc.mode_decide
    pass or the decoder's parse put it there (VERDICT r3 task 5).

    refs: (l0, l1) lists of (y, cb, cr) reference plane tuples for inter
    leaves (reference: DecCu::xReconInter / InterPrediction).
    pred_cache: {leaf_index: (pred_y, pred_cb, pred_cr)} inter
    predictions computed by the decision pass (encoder) — skips the MC
    recompute here.
    lmcs_fwd_lut: LMCS forward LUT applied to every inter leaf's LUMA
    prediction (inter slices code residuals in the mapped domain while
    references live in the original domain; reference: Reshape /
    spec 8.7.5.2 — both codec halves apply it here identically).

    Dispatches to the native core (vvc_torch.packer.native_recon) when built —
    bit-exact mirror of this function; pass use_native=False to force the
    numpy oracle path.
    """
    has_inter = any(l.pred == 1 for l in leaves)
    if use_native and not lossless and not any(l.bdpcm for l in leaves):
        # full-tool native core (rect/MTT, ISP, MRL, dep-quant, LMCS
        # chroma, inter+CIIP) — lossless/BDPCM stay on the numpy oracle
        from vvc_torch.packer import native_recon
        if native_recon.available():
            pc = pred_cache
            if has_inter and pc is None:
                # decoder path: compute every inter leaf's prediction up
                # front (batched prepass + per-leaf refined/affine/GPM)
                from vvc_torch.kernels.mc import batch_inter_preds, inter_pred_leaf
                r0, r1 = refs if refs is not None else ([], [])
                pc = batch_inter_preds(leaves, r0, r1, bit_depth,
                                       inter_cfg)
                for i, l in enumerate(leaves):
                    if l.pred == 1 and i not in pc:
                        pc[i] = tuple(
                            inter_pred_leaf(l, comp, r0, r1, bit_depth,
                                            inter_cfg)
                            for comp in range(3))
            if lmcs_fwd_lut is not None and pc:
                pc = {i: (lmcs_fwd_lut[p[0]], p[1], p[2])
                      for i, p in pc.items()}
            return native_recon.reconstruct_leaves_native_v2(
                leaves, recon_planes, qp, bit_depth, orig_planes,
                chroma_qp_fn=chroma_qp, dep_quant=dep_quant,
                pred_cache=pc, lmcs_chroma=lmcs_chroma)
    refs_l0, refs_l1 = refs if refs is not None else ([], [])
    y_pl, cb_pl, cr_pl = recon_planes
    h, w = y_pl.shape
    coded_y = np.zeros(((h + 3) >> 2, (w + 3) >> 2), dtype=bool)
    coded_c = np.zeros(((h // 2 + 3) >> 2, (w // 2 + 3) >> 2), dtype=bool)
    qpc = chroma_qp(qp)
    encode_mode = orig_planes is not None
    o_y, o_cb, o_cr = orig_planes if encode_mode else (None, None, None)

    def dec_levels(lv, w, h):
        return lv if lv is not None else np.zeros((h, w), dtype=np.int32)

    from vvc_torch.kernels.transform import MTS_TR
    from vvc_torch.kernels.cclm import luma_ds_region
    from vvc_torch.kernels.mc import inter_pred_leaf

    def _planar_pred(plane_, coded_, x0_, y0_, s_, bd_):
        c = build_ref_line(plane_, coded_, x0_, y0_, s_, bd_)
        return predict_intra(c, 0, s_, bd_)

    def _ciip_blend(pred_inter, plane_, coded_, x0_, y0_, s_, bd_):
        # CIIP (reference: InterPrediction::geoMergeCiip / spec 8.5.6.6):
        # merge motion + planar intra from RECONSTRUCTED neighbours,
        # equal-weight blend — execution of the parsed/decided flag
        pi = _planar_pred(plane_, coded_, x0_, y0_, s_, bd_)
        return (pred_inter + pi + 1) >> 1
    cs_fwd = cs_inv = None
    if lmcs_chroma is not None:
        from vvc_torch.kernels.lmcs import chroma_scale_factors
        cs_fwd, cs_inv = chroma_scale_factors(lmcs_chroma, bit_depth)
        cs_starts = np.concatenate(
            [[0], np.cumsum(np.asarray(lmcs_chroma, np.int64))])
    # incrementally-refreshed downsampled-luma plane for CCLM leaves:
    # only the leaf's neighbourhood is recomputed (region-local; the old
    # whole-plane downsample per leaf was O(leaves x frame))
    ds_plane = np.zeros((h >> 1, w >> 1), dtype=np.int32)
    # inter predictions: the encoder's decision pass already computed
    # them (pred_cache); the decoder runs the batched prepass here (every
    # non-refined translational leaf's MC is independent of the current
    # frame's recon — vvc_torch.kernels.mc.batch_inter_preds)
    pre_inter = pred_cache if pred_cache is not None else {}
    if pred_cache is None and any(l.pred == 1 for l in leaves):
        from vvc_torch.kernels.mc import batch_inter_preds
        pre_inter = batch_inter_preds(leaves, refs_l0, refs_l1, bit_depth,
                                      inter_cfg)

    for li_, leaf in enumerate(leaves):
        lw, lh = leaf.w, leaf.h
        x0, y0 = leaf.x0, leaf.y0
        th, tv = MTS_TR[leaf.mts]
        is_inter = leaf.pred == 1
        pred_y = pred_cb = pred_cr = None
        if is_inter:
            if li_ in pre_inter:
                pred_y, pred_cb, pred_cr = pre_inter[li_]
            else:
                pred_y = inter_pred_leaf(leaf, 0, refs_l0, refs_l1,
                                         bit_depth, inter_cfg)
                pred_cb = inter_pred_leaf(leaf, 1, refs_l0, refs_l1,
                                          bit_depth, inter_cfg)
                pred_cr = inter_pred_leaf(leaf, 2, refs_l0, refs_l1,
                                          bit_depth, inter_cfg)
            if lmcs_fwd_lut is not None:
                pred_y = lmcs_fwd_lut[pred_y]
            if leaf.ciip:
                pred_y = _ciip_blend(pred_y, y_pl, coded_y, x0, y0, lw,
                                     bit_depth)
                pred_cb = _ciip_blend(pred_cb, cb_pl, coded_c, x0 >> 1,
                                      y0 >> 1, lw >> 1, bit_depth)
                pred_cr = _ciip_blend(pred_cr, cr_pl, coded_c, x0 >> 1,
                                      y0 >> 1, lw >> 1, bit_depth)
        if leaf.isp and not is_inter:
            # ISP: K sub-TUs reconstructed in coding order; each one's
            # prediction sees the previous sub-TUs through the coded map
            # (reference: IntraSearch::xIntraCodingLumaISP's sequential
            # recon feedback).  Implicit DST7/DCT2 transform per dim.
            from vvc_torch.kernels.isp import isp_partitions, isp_tr_types
            parts = isp_partitions(lw, lh, leaf.isp)
            dec_lev_full = (None if encode_mode
                            else dec_levels(leaf.lev_y, lw, lh))
            enc_lev = np.zeros((lh, lw), dtype=np.int32)
            for (xo, yo, sw, sh) in parts:
                sth, stv = isp_tr_types(sw, sh)
                sub = _recon_block(
                    y_pl, o_y, coded_y, x0 + xo, y0 + yo, sw, leaf.luma_mode,
                    qp, bit_depth,
                    None if encode_mode
                    else dec_lev_full[yo:yo + sh, xo:xo + sw],
                    sth, stv, lossless, intra=True, dep_quant=dep_quant,
                    h=sh)
                if encode_mode:
                    enc_lev[yo:yo + sh, xo:xo + sw] = sub
                coded_y[(y0 + yo) >> 2:(y0 + yo + sh) >> 2,
                        (x0 + xo) >> 2:(x0 + xo + sw) >> 2] = True
            if encode_mode:
                leaf.lev_y = enc_lev if np.any(enc_lev) else None
        else:
            if lossless and encode_mode and not is_inter:
                leaf.bdpcm, leaf.luma_mode = _decide_bdpcm(
                    y_pl, o_y, coded_y, x0, y0, lw, lh, leaf.luma_mode,
                    bit_depth)
            lev = _recon_block(y_pl, o_y, coded_y, x0, y0, lw, leaf.luma_mode,
                               qp, bit_depth,
                               None if encode_mode else dec_levels(leaf.lev_y,
                                                                   lw, lh),
                               th, tv, lossless, pred=pred_y,
                               intra=not is_inter,
                               dep_quant=dep_quant, lfnst=leaf.lfnst, h=lh,
                               bdpcm=leaf.bdpcm, mrl=leaf.mrl)
            if encode_mode:
                leaf.lev_y = lev if np.any(lev) else None
        # chroma (single tree, DM mode = luma mode; MIP maps to planar),
        # half resolution
        dm_mode = 0 if leaf.luma_mode >= 67 else leaf.luma_mode
        cw, ch = lw >> 1, lh >> 1
        cx, cy = x0 >> 1, y0 >> 1
        cscale = None
        if cs_fwd is not None and not lossless:
            # piece of the mapped-domain luma average of this leaf (the
            # leaf's luma recon just completed — both sides see the same
            # samples); reference: Reshape chroma scaling, spec 8.7.5.3
            avg = int(y_pl[y0:y0 + lh, x0:x0 + lw].mean())
            pi = max(0, min(15, int(np.searchsorted(cs_starts, avg,
                                                    side="right")) - 1))
            cscale = (int(cs_fwd[pi]), int(cs_inv[pi]))
        ds = None
        if leaf.chroma_mode and not is_inter:
            # refresh the leaf's DS neighbourhood (luma of this leaf was
            # just reconstructed; its causal neighbours earlier)
            ry0, rx0 = max(0, cy - 1), max(0, cx - 1)
            ds_plane[ry0:cy + ch, rx0:cx + cw] = luma_ds_region(
                y_pl, rx0, ry0, cx + cw - rx0, cy + ch - ry0)
            ds = (ds_plane, leaf.chroma_mode)
        lev = _recon_block(cb_pl, o_cb, coded_c, cx, cy, cw, dm_mode,
                           qpc, bit_depth,
                           None if encode_mode else dec_levels(leaf.lev_cb,
                                                               cw, ch),
                           lossless=lossless, cclm_ds=ds, pred=pred_cb,
                           intra=not is_inter, dep_quant=dep_quant, h=ch,
                           chroma_scale=cscale)
        if encode_mode:
            leaf.lev_cb = lev if np.any(lev) else None
        lev = _recon_block(cr_pl, o_cr, coded_c, cx, cy, cw, dm_mode,
                           qpc, bit_depth,
                           None if encode_mode else dec_levels(leaf.lev_cr,
                                                               cw, ch),
                           lossless=lossless, cclm_ds=ds, pred=pred_cr,
                           intra=not is_inter, dep_quant=dep_quant, h=ch,
                           chroma_scale=cscale)
        if encode_mode:
            leaf.lev_cr = lev if np.any(lev) else None
        # mark availability
        coded_y[y0 >> 2:(y0 + lh) >> 2, x0 >> 2:(x0 + lw) >> 2] = True
        coded_c[cy >> 2:max((cy >> 2) + 1, (cy + ch) >> 2),
                cx >> 2:max((cx >> 2) + 1, (cx + cw) >> 2)] = True

"""HLS writers: SPS/PPS/slice-header RBSP serialization.

TPU-native analog of the reference's HLSWriter
(`VTM/source/Lib/EncoderLib/VLCWriter.cpp` → codeSPS / codePPS /
codeSliceHeader).  Field order follows the spec shape where implemented;
fields not yet supported are simply absent and the parser mirrors that
([verify] — to be made spec-complete as tools land).
"""
from __future__ import annotations

from vvc_torch.io.bitio import BitWriter
from vvc_torch.hls.ps import SPS, PPS, SliceHeader


def write_sps(sps: SPS) -> bytes:
    from vvc_torch.hls.ps import derive_level
    bw = BitWriter()
    # profile_tier_level first (spec 7.3.3)
    bw.write(sps.profile_idc, 7)
    bw.write(sps.tier_flag, 1)
    bw.write(sps.level_idc or derive_level(sps.width, sps.height), 8)
    bw.write(sps.sps_id, 4)
    bw.write(sps.chroma_format_idc, 2)
    bw.write_ue(sps.width)
    bw.write_ue(sps.height)
    bw.write_ue(sps.bit_depth - 8)
    bw.write_ue((sps.ctu_size.bit_length() - 1) - 5)       # log2_ctu_size_minus5
    bw.write_ue((sps.min_cu_size.bit_length() - 1) - 2)    # log2_min_cu_minus2
    bw.write_ue(sps.max_mtt_depth_intra)
    for flag in (sps.mip, sps.isp, sps.mrl, sps.cclm, sps.mts_intra,
                 sps.lfnst, sps.dep_quant, sps.sao, sps.alf, sps.lmcs,
                 sps.deblocking, sps.lossless, sps.bdof, sps.dmvr,
                 sps.affine, sps.mmvd, sps.ciip, sps.gpm,
                 sps.amvr, sps.smvd, sps.bcw):
        bw.write_flag(flag)
    bw.byte_align()
    return bw.get_bytes()


def write_pps(pps: PPS) -> bytes:
    bw = BitWriter()
    bw.write(pps.pps_id, 6)
    bw.write(pps.sps_id, 4)
    bw.write_se(pps.init_qp - 26)
    bw.write_se(pps.cb_qp_offset)
    bw.write_se(pps.cr_qp_offset)
    bw.write_ue(pps.num_tile_cols - 1)
    bw.write_ue(pps.num_tile_rows - 1)
    bw.write_flag(pps.wpp)
    bw.byte_align()
    return bw.get_bytes()


def write_slice_header(sh: SliceHeader, init_qp: int,
                       entry_sizes=None, alf=None, lmcs_cw=None,
                       lmcs_enabled: bool = False,
                       alf_aps_id: int = 0, lmcs_aps_id: int = 0) -> bytes:
    """Slice header RBSP bits (byte-aligned); CABAC payload is appended by
    the caller (slice_data starts at a byte boundary, spec 7.3.7).

    entry_sizes: byte lengths of the tile substreams; all but the last are
    written as entry-point offsets (spec sh_entry_point_offset_minus1).
    alf: (luma_present, ctu_flag_list|None, chroma_present) — the FILTERS
    ride APS NALs (vvc_torch.hls.aps, spec 7.3.2.5); the header carries
    only the activation flags + referenced aps id (spec sh_alf_aps_id_luma) and the
    per-CTU on/off flags ([verify]: spec codes alf_ctb_flag in CABAC slice
    data; kept as header bits here)."""
    bw = BitWriter()
    bw.write(sh.pps_id, 6)
    bw.write_ue(sh.slice_type)
    bw.write(sh.poc & 0xFFFF, 16)
    bw.write_se(sh.qp - init_qp)
    # RPL-based DPB retention list (PH-in-SH layout; spec
    # sh_picture_header_in_slice_header_flag + RPL marking)
    bw.write_ue(len(sh.retained_deltas))
    for d in sh.retained_deltas:
        bw.write_se(d)
    if sh.slice_type != 2:            # P/B: explicit RPL as POC deltas
        bw.write_ue(len(sh.l0_deltas))
        for d in sh.l0_deltas:
            bw.write_se(d)
        if sh.slice_type == 0:        # B
            bw.write_ue(len(sh.l1_deltas))
            for d in sh.l1_deltas:
                bw.write_se(d)
    if lmcs_enabled or lmcs_cw is not None:
        # the present-flag is written whenever the SPS enables LMCS (the
        # parser mirrors that unconditionally); inter slices that skip the
        # mapping write 0 — keeps streams decodable (spec sh_lmcs_used_flag)
        bw.write_flag(lmcs_cw is not None)
        if lmcs_cw is not None:
            bw.write(lmcs_aps_id, 5)  # sh_lmcs_aps_id
    if alf is not None:
        luma, flags, chroma = alf
        bw.write_flag(luma is not None)   # sh_alf_enabled (luma)
        if luma is not None:
            bw.write(alf_aps_id, 5)       # sh_alf_aps_id_luma
            for f in flags:
                bw.write_flag(f)
        bw.write_flag(chroma is not None)  # sh_alf_cb/cr_enabled
        if chroma is not None:
            bw.write(alf_aps_id, 5)
    if entry_sizes and len(entry_sizes) > 1:
        for sz in entry_sizes[:-1]:
            bw.write_ue(sz - 1)
    bw.byte_align()
    return bw.get_bytes()

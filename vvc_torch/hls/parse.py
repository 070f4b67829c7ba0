"""HLS parsers — exact mirrors of vvc_torch.hls.write.

Copy of vvc/hls/parse.py with its imports rewritten.

TPU-native analog of the reference's HLSyntaxReader
(`VTM/source/Lib/DecoderLib/VLCReader.cpp` → parseSPS /
parsePPS / parseSliceHeader).  OpenVVC counterpart: libovvc/nvcl_sps.c etc.
"""
from __future__ import annotations

from vvc_torch.io.bitio import BitReader
from vvc_torch.hls.ps import SPS, PPS, SliceHeader


def parse_sps(rbsp: bytes) -> SPS:
    from vvc_torch.hls.ps import LEVEL_MAX_LUMA_PS
    br = BitReader(rbsp)
    profile = br.read(7)
    tier = br.read(1)
    level = br.read(8)
    sps_id = br.read(4)
    chroma = br.read(2)
    width = br.read_ue()
    height = br.read_ue()
    bit_depth = br.read_ue() + 8
    ctu = 1 << (br.read_ue() + 5)
    min_cu = 1 << (br.read_ue() + 2)
    mtt = br.read_ue()
    names = ("mip", "isp", "mrl", "cclm", "mts_intra", "lfnst",
             "dep_quant", "sao", "alf", "lmcs", "deblocking", "lossless",
             "bdof", "dmvr", "affine", "mmvd", "ciip", "gpm", "amvr",
             "smvd", "bcw")
    flags = {n: bool(br.read_flag()) for n in names}
    # level conformance (spec A.4.1): the stream must not exceed the
    # signalled level's MaxLumaPs
    max_ps = LEVEL_MAX_LUMA_PS.get(level)
    if max_ps is not None and width * height > max_ps:
        raise ValueError(
            f"picture {width}x{height} exceeds level {level/16:.1f} "
            f"MaxLumaPs {max_ps}")
    return SPS(sps_id=sps_id, width=width, height=height,
               bit_depth=bit_depth, chroma_format_idc=chroma,
               profile_idc=profile, tier_flag=tier, level_idc=level,
               ctu_size=ctu, min_cu_size=min_cu,
               max_mtt_depth_intra=mtt, **flags)


def parse_pps(rbsp: bytes) -> PPS:
    br = BitReader(rbsp)
    pps_id = br.read(6)
    sps_id = br.read(4)
    init_qp = br.read_se() + 26
    cb_off = br.read_se()
    cr_off = br.read_se()
    cols = br.read_ue() + 1
    rows = br.read_ue() + 1
    wpp = bool(br.read_flag())
    return PPS(pps_id, sps_id, init_qp, cb_off, cr_off, cols, rows, wpp)


def parse_slice_header(rbsp: bytes, init_qp: int, num_tiles: int = 1,
                       alf_enabled: bool = False, n_ctus: int = 0,
                       lmcs_enabled: bool = False):
    """Returns (SliceHeader, [tile substream bytes, ...], alf, lmcs_cw)
    where alf = (luma_coeffs|None, ctu_flag_list|None, chroma_coeffs|None)
    or None and lmcs_cw = 16 codeword counts or None."""
    br = BitReader(rbsp)
    pps_id = br.read(6)
    stype = br.read_ue()
    poc = br.read(16)
    qp = br.read_se() + init_qp
    retained = tuple(br.read_se() for _ in range(br.read_ue()))
    l0_deltas = l1_deltas = ()
    if stype != 2:
        l0_deltas = tuple(br.read_se() for _ in range(br.read_ue()))
        if stype == 0:
            l1_deltas = tuple(br.read_se() for _ in range(br.read_ue()))
    lmcs_cw = None                     # (aps_id) reference, resolved by caller
    if lmcs_enabled:
        if br.read_flag():
            lmcs_cw = ("aps", br.read(5))
    alf = None
    if alf_enabled:
        luma = flags = chroma = None
        if br.read_flag():
            luma = ("aps", br.read(5))     # sh_alf_aps_id_luma
            flags = [bool(br.read_flag()) for _ in range(n_ctus)]
        if br.read_flag():
            chroma = ("aps", br.read(5))
        alf = (luma, flags, chroma)
    sizes = [br.read_ue() + 1 for _ in range(max(0, num_tiles - 1))]
    br.byte_align()
    payload = br.bytes_remaining_from_aligned()
    subs = []
    off = 0
    for sz in sizes:
        subs.append(payload[off:off + sz])
        off += sz
    subs.append(payload[off:])
    return (SliceHeader(pps_id, stype, poc, qp, l0_deltas, l1_deltas,
                        retained_deltas=retained),
            subs, alf, lmcs_cw)

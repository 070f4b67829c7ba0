"""High-level syntax parameter sets (SPS/PPS/slice header) as frozen
dataclasses.

TPU-native analog of the reference's parameter-set model
(`VTM/source/Lib/CommonLib/Slice.h` → SPS/PPS/Slice;
EncoderLib/EncLib.cpp → xInitSPS/xInitPPS).  Per SURVEY.md §5.6 the config
is "compiled into parameter sets"; these objects are hashable/static so
they can be closed over by jitted device code.

Round-1 field subset: enough to describe the All-Intra QT-only operating
point.  The writers in vvc_torch.hls.write serialize a spec-shaped (but not yet
spec-complete [verify]) RBSP; vvc_torch.hls.parse mirrors them exactly.
"""
from __future__ import annotations

import dataclasses


# Level limits: general_level_idc/16 -> max luma picture size (spec
# Annex A Table A.1 MaxLumaPs)
LEVEL_MAX_LUMA_PS = {
    16: 36864, 32: 122880, 35: 245760, 48: 552960, 51: 983040,
    64: 2228224, 67: 2228224, 80: 8912896, 83: 8912896,
    86: 8912896, 96: 35651584, 99: 35651584, 102: 35651584,
}


def derive_level(width: int, height: int) -> int:
    """Smallest general_level_idc whose MaxLumaPs fits the picture
    (spec A.4.1; idc = level number x 16)."""
    ps = width * height
    for lv in sorted(LEVEL_MAX_LUMA_PS):
        if ps <= LEVEL_MAX_LUMA_PS[lv]:
            return lv
    return 102


@dataclasses.dataclass(frozen=True)
class SPS:
    sps_id: int = 0
    width: int = 0
    height: int = 0
    # profile_tier_level (spec 7.3.3; first syntax in the SPS):
    # profile 1 = Main-10 analog of this custom format
    profile_idc: int = 1
    tier_flag: int = 0
    level_idc: int = 0                # 0 = derive from picture size
    bit_depth: int = 8
    chroma_format_idc: int = 1        # 4:2:0
    ctu_size: int = 64
    min_cu_size: int = 8              # min QT leaf (luma)
    max_mtt_depth_intra: int = 0      # QT-only round 1
    # tool flags (default off in round 1; listed so cfg parsing has a home)
    mip: bool = False
    isp: bool = False
    mrl: bool = False
    cclm: bool = False
    mts_intra: bool = False
    lfnst: bool = False
    dep_quant: bool = False
    sao: bool = False
    alf: bool = False
    lmcs: bool = False
    deblocking: bool = False
    lossless: bool = False  # transquant bypass (config-5 gate, SURVEY §7.2 S6)
    bdof: bool = False      # bi-directional optical flow
    dmvr: bool = False      # decoder-side MV refinement
    affine: bool = False    # affine motion (4/6-param) + PROF
    mmvd: bool = False      # merge with MVD
    ciip: bool = False      # combined inter/intra prediction
    gpm: bool = False       # geometric partitioning merge mode
    amvr: bool = False      # adaptive MV resolution (full/4-pel MVD)
    smvd: bool = False      # symmetric MVD for bi-prediction
    bcw: bool = False       # bi-prediction with CU-level weights


@dataclasses.dataclass(frozen=True)
class PPS:
    pps_id: int = 0
    sps_id: int = 0
    init_qp: int = 32
    cb_qp_offset: int = 0
    cr_qp_offset: int = 0
    num_tile_cols: int = 1
    num_tile_rows: int = 1
    wpp: bool = False  # entropy_coding_sync (WPP row substreams)


@dataclasses.dataclass
class SliceHeader:
    pps_id: int = 0
    slice_type: int = 2               # I
    poc: int = 0
    qp: int = 32
    # explicit reference picture lists as POC deltas (poc - ref_poc),
    # nearest first (reference: ReferencePictureList / RPL in slice header)
    l0_deltas: tuple = ()
    l1_deltas: tuple = ()
    # RPL-based DPB marking (spec: non-active RPL entries keep pictures
    # alive; Slice::applyReferencePictureListBasedMarking): POC deltas
    # (poc - kept_poc, may be negative) of every decoded picture a LATER
    # picture still references -- the decoder retains exactly these
    retained_deltas: tuple = ()

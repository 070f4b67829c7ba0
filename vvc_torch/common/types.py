"""Core enums and constants of the codec.

TPU-native analog of the reference's CommonLib/TypeDef.h + CommonDef.h
(`VTM/source/Lib/CommonLib/TypeDef.h` → ChannelType/ComponentID/
PredMode enums, tool macros; CommonDef.h → numeric limits).  We keep only
plain ints / IntEnum so values can live inside JAX arrays.
"""
from __future__ import annotations

import enum


class NalUnitType(enum.IntEnum):
    """H.266 NAL unit types (spec Table 5; VTM CommonLib/CommonDef.h NalUnitType)."""

    TRAIL = 0
    STSA = 1
    RADL = 2
    RASL = 3
    IDR_W_RADL = 7
    IDR_N_LP = 8
    CRA = 9
    GDR = 10
    OPI = 12
    DCI = 13
    VPS = 14
    SPS = 15
    PPS = 16
    PREFIX_APS = 17
    SUFFIX_APS = 18
    PH = 19
    AUD = 20
    EOS = 21
    EOB = 22
    PREFIX_SEI = 23
    SUFFIX_SEI = 24


class SliceType(enum.IntEnum):
    # VTM order: B=0, P=1, I=2 (CommonLib/Slice.h → SliceType)
    B = 0
    P = 1
    I = 2


class ComponentID(enum.IntEnum):
    Y = 0
    Cb = 1
    Cr = 2


# --- intra prediction modes (spec 8.4; VTM CommonLib/TypeDef.h) ---
PLANAR_IDX = 0
DC_IDX = 1
HOR_IDX = 18
DIA_IDX = 34
VER_IDX = 50
VDIA_IDX = 66
NUM_LUMA_MODE = 67
NUM_MPM = 6  # planar + 5-entry non-planar list

# chroma
DM_CHROMA_IDX = 67
LM_CHROMA_IDX = 81  # CCLM modes 81..83 (LM, LM_L, LM_T)

# --- geometry limits ---
MAX_CTU_SIZE = 128
MIN_CU_SIZE = 4
MAX_TB_SIZE = 64

# --- sample limits ---
MAX_QP = 63
QP_BD_OFFSET_8 = 0  # 8-bit: qp range 0..63; 10-bit adds 12 (6*(B-8))


def qp_bd_offset(bit_depth: int) -> int:
    return 6 * (bit_depth - 8)


# --- transform types (MTS) ---
class TrType(enum.IntEnum):
    DCT2 = 0
    DST7 = 1
    DCT8 = 2


MAX_TR_DYNAMIC_RANGE = 15  # VTM CommonDef.h MAX_TR_DYNAMIC_RANGE


def clip3(lo, hi, x):
    return max(lo, min(hi, x))

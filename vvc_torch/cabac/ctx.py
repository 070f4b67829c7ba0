"""Context model sets for slice-level CABAC state.

TPU-native analog of the reference's context tables
(`VTM/source/Lib/CommonLib/Contexts.cpp` → ContextSetCfg, one
CtxSet per syntax-element family; ContextModelling.h → CoeffCodingContext).

State is a flat int32 array [n_ctx, 4] = (s0, s1, rate0, rate1) shared
with the native C++ packer (vvc_torch/packer) — Python and C++ operate on the
same memory, so mixing per-bin Python syntax with batched native residual
coding keeps one consistent adaptation state.

[verify]: per-context init values / adaptation rates are uniform
placeholders until the VTM reference is populated (SURVEY.md §0).  Both
encoder and decoder construct contexts from this registry, so streams stay
self-consistent; only compression efficiency is affected.
"""
from __future__ import annotations

import numpy as np

from vvc_torch.cabac.engine import RATE0, RATE1

# (name, count) — mirrors the CtxSet families of the reference needed for
# the intra/QT slice (more are added as tools land)
CTX_SETS = [
    ("SPLIT_CU_FLAG", 3),
    ("SAO_TYPE", 1),
    ("SAO_MERGE", 1),
    ("INTRA_LUMA_REF_IDX", 2),
    ("INTRA_LUMA_MPM_FLAG", 1),
    ("INTRA_LUMA_NOT_PLANAR", 2),
    ("INTRA_CHROMA_PRED_MODE", 1),
    ("CCLM_FLAG", 1),
    ("CCLM_MODE", 1),
    ("CBF_LUMA", 4),
    ("MTS_IDX", 4),
    ("LFNST_IDX", 2),
    ("CBF_CB", 2),
    ("CBF_CR", 3),
    ("LAST_X_LUMA", 20),
    ("LAST_Y_LUMA", 20),
    ("LAST_X_CHROMA", 3),
    ("LAST_Y_CHROMA", 3),
    ("SB_CODED_FLAG_LUMA", 2),
    ("SB_CODED_FLAG_CHROMA", 2),
    ("SIG_LUMA", 12),
    ("SIG_CHROMA", 8),
    ("GT1_LUMA", 16),
    ("GT1_CHROMA", 5),
    ("PAR_LUMA", 16),
    ("PAR_CHROMA", 5),
    ("GT3_LUMA", 16),
    ("GT3_CHROMA", 5),
    # inter syntax families (S4; appended to keep existing offsets stable)
    ("CU_SKIP_FLAG", 3),
    ("PRED_MODE", 2),
    ("MERGE_FLAG", 1),
    ("MERGE_IDX", 1),
    ("INTER_DIR", 6),
    ("REF_IDX", 2),
    ("MVP_FLAG", 1),
    ("MVD", 2),
    ("ROOT_CBF", 1),
    ("MIP_FLAG", 1),
    # MTT split syntax (appended to keep existing offsets stable)
    ("SPLIT_QT_FLAG", 2),
    ("MTT_SPLIT_VERT", 2),
    ("MTT_SPLIT_BINARY", 2),
    # ISP (appended)
    ("ISP_MODE", 2),
    # affine (appended; reference: Contexts.cpp AffineFlag/AffineType/
    # SubblockMergeFlag)
    ("AFFINE_FLAG", 3),
    ("AFFINE_TYPE", 1),
    # transform-skip residual coding + BDPCM (appended; reference:
    # Contexts.cpp TsSigCoeffGroup/TsSigFlag/TsResidualSign/TsGtxFlag/
    # TsParFlag, BDPCMMode)
    ("TS_SB", 2),
    ("TS_SIG", 3),
    ("TS_SIGN", 2),
    ("TS_GT1", 2),
    ("TS_PAR", 1),
    ("TS_GT3", 2),
    ("BDPCM_FLAG", 1),
    ("BDPCM_DIR", 1),
    # MMVD (appended; reference: Contexts.cpp MmvdFlag/MmvdMergeIdx/
    # MmvdStepMvpIdx)
    ("MMVD_FLAG", 1),
    ("MMVD_CAND", 1),
    ("MMVD_DIST", 1),
    # CIIP (reference: Contexts.cpp CiipFlag)
    ("CIIP_FLAG", 1),
    # GPM (appended; reference: Contexts.cpp MergeIdx/GeoSubModeIdx —
    # regular_merge_flag's inverse is coded here as one GPM flag bin)
    ("GPM_FLAG", 1),
    ("GPM_IDX", 1),
    # AMVR + SMVD (appended; reference: Contexts.cpp ImvFlag / SmvdFlag)
    ("IMV_FLAG", 2),
    ("SMVD_FLAG", 1),
    ("BCW_IDX", 1),
]

_OFFSETS = {}
_TOTAL = 0
for _name, _count in CTX_SETS:
    _OFFSETS[_name] = _TOTAL
    _TOTAL += _count


def _build_init_tables():
    """Precomputed per-context init states + MEASURED adaptation-rate
    pairs (vvc_torch/cabac/rates_ctx.py, generated by
    tools/measure_ctx_rates.py — VERDICT r4 task 4; the global (4,7)
    placeholder remains the fallback for unmeasured contexts)."""
    import numpy as np_
    init = np_.empty(_TOTAL, dtype=np_.int32)
    rates = np_.empty((_TOTAL, 2), dtype=np_.int32)
    rates[:, 0] = RATE0
    rates[:, 1] = RATE1
    try:
        from vvc_torch.cabac.rates_ctx import CTX_RATES
    except ImportError:
        CTX_RATES = {}
    for name, count in CTX_SETS:
        vals = INIT_STATES.get(name, [64] * count)
        off = _OFFSETS[name]
        for i in range(count):
            init[off + i] = vals[i] << 8
            pr = CTX_RATES.get((name, i))
            if pr is not None:
                rates[off + i] = pr
    return init, rates

# sets consumed by the native residual coder, in the order its C++ enum
# expects (keep in sync with vvc_torch/packer/cabac_core.cpp ResidualSets)
RESIDUAL_SET_ORDER = [
    "LAST_X_LUMA", "LAST_Y_LUMA", "LAST_X_CHROMA", "LAST_Y_CHROMA",
    "SB_CODED_FLAG_LUMA", "SB_CODED_FLAG_CHROMA",
    "SIG_LUMA", "SIG_CHROMA", "GT1_LUMA", "GT1_CHROMA",
    "PAR_LUMA", "PAR_CHROMA", "GT3_LUMA", "GT3_CHROMA",
]



# Data-driven default initial states (7-bit probability of '1', p = v/128),
# measured from converged context statistics over synthetic AI content at
# QP 27/32/37 — the same methodology as the reference's trained init tables
# (Contexts.cpp initValues), to be [verify]-swapped for the spec values
# when the VTM reference is populated.
INIT_STATES = {
    "SPLIT_CU_FLAG": [71, 95, 106],
    "SAO_TYPE": [76],
    "SAO_MERGE": [64],
    "INTRA_LUMA_REF_IDX": [3, 64],
    "INTRA_LUMA_MPM_FLAG": [77],
    "INTRA_LUMA_NOT_PLANAR": [68, 64],
    "INTRA_CHROMA_PRED_MODE": [126],
    "CCLM_FLAG": [13],
    "CBF_LUMA": [113, 64, 64, 64],
    "MTS_IDX": [67, 70, 37, 45],
    "CBF_CB": [11, 64],
    "CBF_CR": [46, 31, 64],
    "LAST_X_LUMA": [64, 64, 64, 91, 117, 81, 67, 66, 64, 64,
                    64, 64, 64, 64, 64, 64, 64, 64, 64, 64],
    "LAST_Y_LUMA": [64, 64, 64, 84, 120, 72, 74, 65, 67, 63,
                    64, 64, 64, 64, 64, 64, 64, 64, 64, 64],
    "LAST_X_CHROMA": [19, 59, 64],
    "LAST_Y_CHROMA": [18, 59, 63],
    "SB_CODED_FLAG_LUMA": [44, 114],
    "SB_CODED_FLAG_CHROMA": [64, 64],
    "SIG_LUMA": [15, 44, 68, 86, 7, 44, 73, 95, 35, 76, 84, 107],
    "SIG_CHROMA": [58, 67, 65, 64, 58, 72, 67, 66],
    "GT1_LUMA": [17, 25, 39, 44, 65, 25, 39, 52, 66, 86, 49, 59, 68, 71, 71, 64],
    "GT1_CHROMA": [55, 63, 65, 65, 66],
    "PAR_LUMA": [35, 35, 43, 50, 45, 47, 51, 50, 62, 54, 42, 50, 51, 61, 57, 64],
    "PAR_CHROMA": [46, 60, 62, 63, 64],
    "GT3_LUMA": [25, 27, 34, 34, 34, 40, 41, 56, 65, 74, 40, 40, 48, 52, 64, 64],
    "GT3_CHROMA": [48, 59, 63, 62, 61],
}

class CtxRef:
    """View of one context inside the shared state array; implements the
    same interface as engine.ContextModel."""

    __slots__ = ("_a", "_i")

    def __init__(self, arr: np.ndarray, idx: int):
        self._a = arr
        self._i = idx

    @property
    def s0(self):
        return int(self._a[self._i, 0])

    @property
    def s1(self):
        return int(self._a[self._i, 1])

    def prob(self) -> int:
        return (int(self._a[self._i, 0]) + int(self._a[self._i, 1])) >> 1

    def mps(self) -> int:
        return 1 if self.prob() >= (1 << 14) else 0

    def lps_range(self, rng: int) -> int:
        p = self.prob()
        q = p if p < (1 << 14) else ((1 << 15) - 1 - p)
        return (((q >> 9) * (rng >> 5)) >> 1) + 4

    def update(self, bin_val: int):
        a, i = self._a, self._i
        target = bin_val << 15
        a[i, 0] = int(a[i, 0]) + ((target - int(a[i, 0])) >> int(a[i, 2]))
        a[i, 1] = int(a[i, 1]) + ((target - int(a[i, 1])) >> int(a[i, 3]))


_INIT_COL, _RATE_COLS = _build_init_tables()


class SliceContexts:
    """All adaptive contexts of one slice (reference: Ctx / CtxStore)."""

    def __init__(self, slice_qp: int = 32):
        self.states = np.empty((_TOTAL, 4), dtype=np.int32)
        self.states[:, :2] = _INIT_COL[:, None]
        self.states[:, 2:] = _RATE_COLS

    def __call__(self, name: str, idx: int) -> CtxRef:
        return CtxRef(self.states, _OFFSETS[name] + idx)

    def index(self, name: str, idx: int = 0) -> int:
        return _OFFSETS[name] + idx

    def set_size(self, name: str) -> int:
        return dict(CTX_SETS)[name]

    def residual_offsets(self) -> np.ndarray:
        return np.array([_OFFSETS[n] for n in RESIDUAL_SET_ORDER], dtype=np.int32)

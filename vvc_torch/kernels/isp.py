"""ISP — intra sub-partitions: geometry, legality, implicit transforms.

Copy of vvc/kernels/isp.py (host code; the RD search's ISP stage is
vvc_torch.enc.rdo.eval_isp_dir).

TPU-native analog of the reference's ISP tooling
(`VTM/source/Lib/CommonLib/UnitTools.cpp` →
CU::canUseISP / getISPType; IntraSearch.cpp → estIntraPredLumaQT's ISP
loops; TrQuant selecting implicit DST7 for ISP TBs).

Deviations (self-consistent encoder/decoder; flagged [verify]):
  * sub-partition count K keeps every sub-TU dimension ≥ 4 (K = 4 when
    the split dimension ≥ 16, else 2) so the per-4×4 availability maps,
    LFNST gating and residual scan templates all stay in-range — the
    spec's 1/2-row sub-TUs (e.g. 8×2) are not produced.
  * every sub-TU's cbf is signalled explicitly (the spec infers the last
    one when all previous are zero; explicit coding removes the encoder's
    at-least-one-nonzero obligation for ~1 bit per ISP CU).
  * LFNST and MTS are off for ISP leaves (transform types are implicit).
"""
from __future__ import annotations

from vvc_torch.common.types import TrType

ISP_OFF, ISP_HOR, ISP_VER = 0, 1, 2


def isp_allowed(w: int, h: int) -> tuple[bool, bool]:
    """(can_hor, can_ver) for a W×H luma CB.  Both require the split
    dimension ≥ 8 (so sub-TUs keep min dim 4) and sides ≤ 64."""
    if w > 64 or h > 64:
        return False, False
    return h >= 8, w >= 8


def isp_partitions(w: int, h: int, direction: int):
    """[(x_off, y_off, sub_w, sub_h)] for the K sub-TUs, coding order."""
    if direction == ISP_HOR:
        k = 4 if h >= 16 else 2
        sh = h // k
        return [(0, i * sh, w, sh) for i in range(k)]
    if direction == ISP_VER:
        k = 4 if w >= 16 else 2
        sw = w // k
        return [(i * sw, 0, sw, h) for i in range(k)]
    return [(0, 0, w, h)]


def isp_tr_types(sub_w: int, sub_h: int) -> tuple[int, int]:
    """Implicit (tr_h, tr_v) for an ISP sub-TU: DST7 when the dimension is
    in [4, 16], DCT2 otherwise (reference: TrQuant implicit-MTS rule for
    ISP)."""
    th = TrType.DST7 if 4 <= sub_w <= 16 else TrType.DCT2
    tv = TrType.DST7 if 4 <= sub_h <= 16 else TrType.DCT2
    return th, tv

"""Frame-level coding state: SoA maps instead of the reference's CU object
graph.

TPU-native analog of the reference's CodingStructure/Unit data model
(`VTM/source/Lib/CommonLib/CodingStructure.cpp`, Unit.cpp,
UnitTools.cpp).  Per SURVEY.md §7.0 tenet 1, the CU/PU/TU pointer web
becomes per-4×4 tensor fields (mode plane, depth plane, coded plane); a
flat z-order leaf list carries per-block payloads (levels) between the
syntax and reconstruction phases — the "parse all, then reconstruct"
split that makes the decoder batchable (OpenVVC's drv/rcn split).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Leaf:
    """One coding unit (single tree: luma + collocated chroma).

    Rectangular (MTT BT/TT leaves): w != h.  `size` is a convenience view
    for the square-only tool paths and asserts squareness — rect-aware
    code reads .w/.h directly.
    """

    x0: int
    y0: int
    w: int
    h: int
    luma_mode: int = 0
    mts: int = 0  # MTS index: 0 DCT2/DCT2, 1 DST7/DST7, 2 DCT8/DST7, 3 DST7/DCT8, 4 DCT8/DCT8
    lfnst: int = 0  # LFNST kernel index (0 off, 1/2); luma, DCT2-only
    isp: int = 0  # intra sub-partitions: 0 off, 1 horizontal, 2 vertical
    mrl: int = 0  # multi-reference-line index: 0, 1 or 2 (luma intra)
    bdpcm: int = 0  # lossless TS tier: 0 off, 1 horizontal, 2 vertical
    ciip: bool = False  # combined inter/intra (merge motion + planar blend)
    chroma_mode: int = 0  # 0 = DM (luma mode), 1 = CCLM (LM)
    # inter fields (pred 0 = intra, 1 = inter); MVs in luma quarter-pel
    pred: int = 0
    skip: bool = False
    merge: bool = False
    merge_idx: int = 0
    inter_dir: int = 1            # 1 = L0, 2 = L1, 3 = bi
    mv: tuple = ((0, 0), (0, 0))  # per-list (mvx, mvy)
    ref_idx: tuple = (0, 0)
    mvp_idx: tuple = (0, 0)
    # affine (reference: CodingUnit::affine/affineType + PU mvAffi):
    # 0 = translational, 4/6 = parameter count; cpmv per list =
    # ((TLx,TLy),(TRx,TRy),(BLx,BLy)) in luma 1/4-pel, or None
    affine: int = 0
    cpmv: tuple = (None, None)
    # GPM (reference: CodingUnit::geoFlag + PU geo merge indices):
    # gpm = (partition_mode 0..63, merge_idx0, merge_idx1) or None;
    # gpm_mv = the two derived uni candidates ((list, (mvx,mvy), ref),
    # (list, (mvx,mvy), ref)).  leaf.mv/ref_idx/inter_dir hold part 0's
    # motion for the 4x4 field ([verify] spec stores per-part + bi in the
    # blend band; whole-CU part-0 storage is the documented simplification
    # shared by both codec halves).
    gpm: tuple | None = None
    gpm_mv: tuple | None = None
    # BCW (reference: CodingUnit::bcwIdx): index into the CU-level
    # bi-prediction weight table w1 in (-2,3,4,5,10)/8; 2 = equal weights.
    # Non-default weights are AMVP-only here (merge inheritance is the
    # spec's path; documented simplification)
    bcw: int = 2
    # encoder-side precomputed syntax values (vvc_torch.enc.mode_decide): the
    # decision pass derives these ONCE against its mirrored MotionState so
    # neither recon nor the syntax writer re-derives merge/AMVP lists.
    # None = underived (writer falls back to derive-at-write).
    decided: bool = False            # mode_decide pass ran for this leaf
    merge_match: int | None = None   # merge candidate idx equal to leaf.mv
    mmvd: tuple | None = None        # (base_cand, dist_idx, dir_idx)
    amvp: tuple | None = None        # per-list (l, mvp_idx, dx, dy) or
    #                                  (l, mvp_idx, ((dx,dy),...)) affine
    smvd: bool = False               # symmetric-MVD signalling chosen
    imv: int = 0                     # AMVR tier derived at decision time
    # quantized levels; None until reconstruction (encoder) / parse (decoder)
    lev_y: np.ndarray | None = None
    lev_cb: np.ndarray | None = None
    lev_cr: np.ndarray | None = None

    @property
    def size(self) -> int:
        assert self.w == self.h, "rect leaf: use .w/.h"
        return self.w

    @property
    def cbf_y(self) -> int:
        return int(self.lev_y is not None and np.any(self.lev_y))

    def sub_cbf_y(self, part) -> int:
        """cbf of one ISP sub-TU; part = (x_off, y_off, sub_w, sub_h)."""
        if self.lev_y is None:
            return 0
        xo, yo, sw, sh = part
        return int(np.any(self.lev_y[yo:yo + sh, xo:xo + sw]))

    @property
    def cbf_cb(self) -> int:
        return int(self.lev_cb is not None and np.any(self.lev_cb))

    @property
    def cbf_cr(self) -> int:
        return int(self.lev_cr is not None and np.any(self.lev_cr))


class CodingState:
    """Per-4×4 SoA planes consulted by syntax coding and reconstruction.

    Kept identically by encoder and decoder so context derivations and
    reference-sample availability can never diverge.
    """

    def __init__(self, width: int, height: int):
        self.w4 = (width + 3) >> 2
        self.h4 = (height + 3) >> 2
        self.mode_map = np.full((self.h4, self.w4), -1, dtype=np.int16)
        self.depth_map = np.zeros((self.h4, self.w4), dtype=np.int8)
        self.coded_map = np.zeros((self.h4, self.w4), dtype=bool)       # luma units
        self.coded_map_c = np.zeros(((height // 2 + 3) >> 2, (width // 2 + 3) >> 2),
                                    dtype=bool)                          # chroma units

    def set_cu(self, x0: int, y0: int, size: int, mode: int, depth: int,
               h: int | None = None):
        w = size
        h = w if h is None else h
        w4, h4 = w >> 2, h >> 2
        self.mode_map[y0 >> 2:(y0 >> 2) + h4, x0 >> 2:(x0 >> 2) + w4] = mode
        self.depth_map[y0 >> 2:(y0 >> 2) + h4, x0 >> 2:(x0 >> 2) + w4] = depth

    def mark_coded(self, x0: int, y0: int, size: int, h: int | None = None):
        w = size
        h = w if h is None else h
        w4, h4 = w >> 2, h >> 2
        self.coded_map[y0 >> 2:(y0 >> 2) + h4, x0 >> 2:(x0 >> 2) + w4] = True
        cw4, ch4 = max(1, w >> 3), max(1, h >> 3)
        self.coded_map_c[y0 >> 3:(y0 >> 3) + ch4,
                         x0 >> 3:(x0 >> 3) + cw4] = True

    def mode_at(self, x: int, y: int) -> int:
        """Intra mode of the 4×4 unit containing luma sample (x, y); -1 if
        out of frame or not yet coded."""
        if x < 0 or y < 0 or (x >> 2) >= self.w4 or (y >> 2) >= self.h4:
            return -1
        if not self.coded_map[y >> 2, x >> 2]:
            return -1
        return int(self.mode_map[y >> 2, x >> 2])

    def depth_at(self, x: int, y: int) -> int:
        if x < 0 or y < 0 or (x >> 2) >= self.w4 or (y >> 2) >= self.h4:
            return -1
        if not self.coded_map[y >> 2, x >> 2]:
            return -1
        return int(self.depth_map[y >> 2, x >> 2])

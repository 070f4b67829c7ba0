"""MCTF — motion-compensated temporal pre-filtering of anchor pictures.

Copy of vvc/enc/mctf.py (reference: `VTM/source/Lib/EncoderLib/
EncTemporalFilter.cpp` → EncTemporalFilter::filter: hierarchical ME of ±2
neighbour originals toward each GOP-boundary picture, per-block
error-adaptive blending before encoding).  Non-normative: it works on the
source pictures only.

The motion search runs on the device as in vvc: the neighbour's padded
and ds4 planes (`me.pic_dev`, kernel `me_prep`), the coarse search
(kernel `me_coarse`) and `me.me_pred_v2` (kernels `me_int`, `me_qpel`,
`me_block_err`).  The blend is vvc's host filter in float64 numpy.

Effect: temporally-independent noise averages out of the anchors that the
whole GOP predicts from — bits drop at equal PSNR-vs-source.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from vvc_torch.io.yuv import Frame
from vvc_torch.enc import me as me_mod
from vvc_torch.ops import resolve_device

BLOCK = 16


def _me_pred(cur_y: np.ndarray, ref_y: np.ndarray, bit_depth: int,
             radius: int = 8, device=None):
    """Motion-compensate ref toward cur at BLOCK granularity; returns the
    prediction plane and the per-block mean squared error map (the window
    engine: coarse ds4 full search + per-block window refine)."""
    refpad, refds = me_mod.pic_dev(ref_y, device)
    h, w = cur_y.shape
    cur_dev = torch.from_numpy(np.ascontiguousarray(cur_y, dtype=np.int32)
                               ).to(device)
    _, cds = me_mod.prep_ref(cur_dev)
    coarse = me_mod.coarse_search(cds, refds[None], me_mod.COARSE_R)
    # vvc passes this Python double as float32
    lam_m = np.float32(math.sqrt(0.57 * 2.0 ** ((32 - 12) / 3.0)))
    plane_d, err_d = me_mod.me_pred_v2(cur_dev, refpad, coarse[16][0], w, h,
                                       bit_depth, lam_m)
    plane = plane_d.cpu().numpy()
    err = err_d.cpu().numpy().astype(np.float64)
    full = cur_y.copy()
    ny, nx = err.shape
    full[:ny * BLOCK, :nx * BLOCK] = plane
    return full, err


def mctf_filter(frames, poc: int, qp: int, bit_depth: int = 8,
                window: int = 2, device=None) -> Frame:
    """Filtered version of frames[poc] using ±window neighbour originals.
    device: None = CUDA (raises without it), "cpu" = the plain path.

    Luma only (the reference filters chroma too with smaller strength —
    [verify]; chroma passes through here)."""
    device = resolve_device(device)
    cur = frames[poc]
    h, w = cur.y.shape
    num = cur.y.astype(np.float64).copy()
    den = np.ones_like(num)
    # error-adaptive weight (reference: s_o·σ² / (err + σ²) shape)
    sigma2 = max(4.0, (qp - 20) * 1.5) ** 1.0 * 10.0
    base_w = 0.4
    for dp in range(-window, window + 1):
        p = poc + dp
        if dp == 0 or p < 0 or p >= len(frames):
            continue
        pred, err = _me_pred(cur.y, frames[p].y, bit_depth, device=device)
        wmap = base_w * sigma2 / (err + sigma2)        # [ny, nx] per block
        wfull = np.ones((h, w)) * 0.0
        ny, nx = err.shape
        wfull[:ny * BLOCK, :nx * BLOCK] = np.repeat(
            np.repeat(wmap, BLOCK, axis=0), BLOCK, axis=1)
        num += wfull * pred
        den += wfull
    y = np.clip(np.rint(num / den), 0, (1 << bit_depth) - 1).astype(np.int32)
    return Frame(y, cur.cb, cur.cr, bit_depth)

"""Synthetic test content (no sequences ship in-repo; the reference CTC
sequences are external).  Gradients + edges + moving box + noise gives a
mix of flat/directional/textured blocks that exercises all intra modes."""
from __future__ import annotations

import numpy as np

from vvc_torch.io.yuv import Frame


def synth_frame(w: int, h: int, t: int = 0, seed: int = 0,
                bit_depth: int = 8) -> Frame:
    rng = np.random.default_rng(seed + t)
    mx = (1 << bit_depth) - 1
    sc = 1 << (bit_depth - 8)
    yy, xx = np.mgrid[0:h, 0:w]
    y = (xx * 255 // max(1, w - 1) + yy * 64 // max(1, h - 1)) % 256
    # block-grid-misaligned texture (real content's edges have arbitrary
    # phase; grid-aligned edges would bias deblocking/RDO measurements)
    y[((xx + 5) // 16 + (yy + 3) // 16) % 2 == 0] //= 2
    bx = (10 + 7 * t) % max(1, w - 16)
    by = (6 + 5 * t) % max(1, h - 16)
    y[by:by + 16, bx:bx + 16] = 230
    y = np.clip(y * sc + rng.integers(-4 * sc, 5 * sc, size=y.shape), 0, mx)
    cb = np.clip((120 + (xx[::2, ::2] // 8) % 16) * sc, 0, mx)
    cr = np.clip((128 - (yy[::2, ::2] // 8) % 16) * sc, 0, mx)
    return Frame(y.astype(np.int32), cb.astype(np.int32), cr.astype(np.int32),
                 bit_depth)

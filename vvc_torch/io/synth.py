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


def motion_clip(n: int, w: int, h: int, bit_depth: int = 8, seed: int = 0,
                motion=(17, -5)) -> list:
    """n frames of one texture in global sub-pel motion: frame t is the
    crop of a 4×-upsampled picture at (x, y) = (motion·t) quarter samples,
    box-downsampled by 4 — (17, −5) quarter samples is (4.25, −1.25) px
    per frame, so both integer and fractional MVs win.  The texture is
    smooth waves plus a fixed noise field; chroma is the luma's 2×2 mean,
    scaled about mid-grey.  Every box average is computed in closed form
    (the waves are separable sums, the noise bilinear), so a 1080p clip
    costs O(h·w) per frame."""
    rng = np.random.default_rng(seed)
    mx, my = motion
    py, px = (abs(my) * n) // 4 + 8, (abs(mx) * n) // 4 + 8
    noise = rng.normal(0.0, 4.0, (h + 2 * py + 1, w + 2 * px + 1))
    out = []
    for t in range(n):
        oy, ox = 4 * py + my * t, 4 * px + mx * t      # quarter samples

        def box(f, o, m):
            """Mean of f over each run of 4 quarter samples from o."""
            q = (o + np.arange(4 * m, dtype=np.float64)) / 4.0
            return f(q).reshape(m, 4).mean(axis=1)
        sx37, cy29 = box(lambda x: np.sin(x / 9.25), ox, w), \
            box(lambda y: np.cos(y / 7.25), oy, h)
        sx61, cx61 = box(lambda x: np.sin(x / 15.25), ox, w), \
            box(lambda x: np.cos(x / 15.25), ox, w)
        c2y, s2y = box(lambda y: np.cos(y / 7.625), oy, h), \
            box(lambda y: np.sin(y / 7.625), oy, h)
        tex = (128.0 + 55.0 * cy29[:, None] * sx37[None, :]
               + 35.0 * (c2y[:, None] * sx61[None, :]
                         + s2y[:, None] * cx61[None, :]))
        # the noise is constant on each sample of the texture's grid: a
        # box of 4 quarter samples from o covers grid cells o // 4 and
        # o // 4 + 1 with weights (4 − o % 4) / 4 and (o % 4) / 4
        qy, ry = oy // 4, oy % 4
        qx, rx = ox // 4, ox % 4
        wy0, wy1, wx0, wx1 = (4 - ry) / 4, ry / 4, (4 - rx) / 4, rx / 4
        nz = noise[qy:qy + h + 1, qx:qx + w + 1]
        tex += (wy0 * (wx0 * nz[:-1, :-1] + wx1 * nz[:-1, 1:])
                + wy1 * (wx0 * nz[1:, :-1] + wx1 * nz[1:, 1:]))
        mxv = (1 << bit_depth) - 1
        sc = 1 << (bit_depth - 8)
        y = np.clip(np.round(tex * sc), 0, mxv).astype(np.int32)
        ds = tex.reshape(h // 2, 2, w // 2, 2).mean(axis=(1, 3))
        cb = np.clip(np.round((128 + 0.4 * (ds - 128)) * sc), 0, mxv)
        cr = np.clip(np.round((128 - 0.3 * (ds - 128)) * sc), 0, mxv)
        out.append(Frame(y, cb.astype(np.int32), cr.astype(np.int32),
                         bit_depth))
    return out

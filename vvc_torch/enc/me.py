"""Window-based batched motion estimation — the translational part.

Port of vvc/enc/me.py (reference: InterSearch.cpp → xMotionEstimation /
xTZSearch / xPatternSearchFracDIF), the engine of the inter search's
device program (vvc_torch.enc.inter_search):

  1. PREP (`prep_ref`, CUDA kernel `me_prep`): a reference picture
     edge-padded by PAD and its 4×4-block mean plane (ds4), once per
     picture (`pic_dev` caches them, as vvc's cache does).
  2. COARSE (`coarse_search`, kernel `me_coarse`): full search on the ds4
     planes over ±COARSE_R, every 4×4 / 8×8 / 16×16 ds4 cell (the 16, 32
     and 64 blocks) of every reference at once; cost SSE + ½ MV bits.
  3. INT (`int_refine`, kernel `me_int`): per block, the window of
     (s + 2·WIN_M)² reference samples at the clipped coarse centre and the
     81 integer displacements in ±R2, cost SSE + √λ·MV bits.
  4. QPEL (`qpel_refine`, kernel `me_qpel`): the 49 quarter-pel offsets in
     ±3 around the integer winner, through the normative 8-tap DCTIF, cost
     SATD + √λ·MV bits; returns the winner's prediction.

  5. AFFINE (`affine_search`, kernels `affine_search` + `affine_dctif`):
     4-parameter corner-delta candidates around the translational seed,
     scored by a bilinear prediction + SATD; the winner's prediction
     through the normative 8-tap DCTIF per 4×4 subblock.
  6. MCTF (`me_pred_v2`): the 16×16 window search of one reference toward
     a picture, its prediction plane and per-block mean squared error
     (kernel `me_block_err`), for vvc_torch.enc.mctf.

vvc's `_int_refine` re-centres the window (w2) with one-hot sums; here the
quarter-pel stage and the affine search read the re-centred window straight
from the padded reference: w2's origin is (ys + PAD + iy − M2,
xs + PAD + ix − M2).

Each stage has a plain PyTorch twin (`*_plain`) with the same integer
semantics.  The float32 costs are bit-equal to vvc's on XLA-CPU (read from
the optimised IR of its jitted programs, jax 0.9.0): XLA's own `log`
(vvc_torch/rom/log_table.py), the MV bits `2·log2(1+|d|) + 1` as one FMA
fma(log(1+|d|), 2/ln 2, 1), `cost = fma(√λ, bits_y + bits_x, sse)`, the
coarse cell sums (c8 = (c4₀₀ + c4₀₁) + (c4₁₀ + c4₁₁), c16 likewise), and
SSE sums above 2^24 in XLA's order (`sse_f32_me`).  Every argmin keeps
the first minimum (strict `<` in vvc's candidate order).

`eval_ref` (vvc/enc/me.py:261, no caller in vvc) is the composition of the
window centres, the integer refine and the quarter-pel refine.
"""
from __future__ import annotations

import ctypes
import weakref
from functools import lru_cache

import numpy as np
import torch

from vvc_torch import ops
from vvc_torch.cabac.rates import log_scale_f32
from vvc_torch.enc.rdo import _fma_f32
from vvc_torch.kernels.mc import LUMA_FILTERS
from vvc_torch.kernels.quant import xla_block_sum
from vvc_torch.kernels.satd import satd_batch_plain, sse_f32
from vvc_torch.rom.log_table import xla_log_f32

PAD = 16        # edge padding baked into cached reference planes
R2 = 4          # full-res integer refinement radius around the coarse MV
WIN_M = 10      # window margin each side of the block (R2 + M2)
M2 = 6          # re-centered window margin (8-tap support + ±2 int pel)
COARSE_R = 8    # coarse search radius in ds4 units (±32 full-res)
AFFINE_ME_SIZES = (16, 32, 64)
AFFINE_BITS = 18.0
# corner-delta candidate grid (qpel at the TR control point), da outer
AFF_DELTAS = (-8, -4, -2, 0, 2, 4, 8)
# the ±1 refinement steps (da, db) around the running best, in vvc's order
AFF_STEPS = tuple((dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)
                  if (dy, dx) != (0, 0))
# the bilinear weights' denominator: every sample position of a candidate
# is a multiple of 1/128 (7 fractional bits at s = 64)
AFF_SCALE = 128

# |MV component| range covered by the MV-bits table (qpel units; the
# search reaches about 4·(32 + 8) + 3)
MV_BITS_N = 4096


# --------------------------------------------------------------------
# float32 rates as vvc's jitted programs compute them on XLA-CPU
# --------------------------------------------------------------------

@lru_cache(maxsize=None)
def mv_bits_table() -> np.ndarray:
    """[MV_BITS_N] float32: vvc's `_mv_bits(d) = 2·log2(1 + |d|) + 1` for
    |d| = 0..MV_BITS_N-1, bit for bit: XLA lowers it to one FMA,
    fma(log(1 + |d|), 2/ln 2, 1), with its own float32 log.  The float64
    product and sum are exact (≤ 48 + 5 bits), so the cast rounds once."""
    log = xla_log_f32()[:MV_BITS_N].astype(np.float64)      # log(1 + |d|)
    val = (log * np.float64(log_scale_f32()) + 1.0).astype(np.float32)
    val.setflags(write=False)
    return val


@lru_cache(maxsize=None)
def _mv_bits_dev(device: str) -> torch.Tensor:
    return torch.from_numpy(mv_bits_table().copy()).to(device)


def mv_bits(d: torch.Tensor) -> torch.Tensor:
    """vvc's `_mv_bits` of an integer tensor → float32."""
    a = d.abs().long()
    assert int(a.max()) < MV_BITS_N if a.numel() else True
    return _mv_bits_dev(str(d.device))[a]


@lru_cache(maxsize=None)
def coarse_bias_table(r: int = COARSE_R) -> np.ndarray:
    """[(2r+1)²] float32: the coarse search's per-displacement bias
    0.5·(_mv_bits(16·dx) + _mv_bits(16·dy)), d = 0..(2r+1)²−1 with
    dy = d // (2r+1) − r, dx = d % (2r+1) − r (one float32 add, then the
    exact halving)."""
    D = 2 * r + 1
    d = np.arange(D * D)
    t = mv_bits_table()
    bx = t[np.abs(16 * (d % D - r))]
    by = t[np.abs(16 * (d // D - r))]
    out = ((bx + by) * np.float32(0.5)).astype(np.float32)
    out.setflags(write=False)
    return out


def sse_f32_me(d: torch.Tensor) -> torch.Tensor:
    """Σ d² per [M, S, S] block as vvc's `_int_refine` sums it in float32:
    exact below 2^24; above (10-bit noise at S ≥ 8, 8 bit at S ≥ 32), XLA's
    order — S = 8, 16, 32 sequentially in row-major order; S = 64 in four
    32×32 windows, each row-major from 0, then (W00 + W01) + (W10 + W11)
    (`kernels.satd.sse_f32` without its 8×8 row lanes)."""
    return sse_f32(d, lanes8=False)


# --------------------------------------------------------------------
# per-picture prep: edge-padded plane + ds4 plane
# --------------------------------------------------------------------

def prep_ref_plain(plane: torch.Tensor):
    """Plain twin of vvc/enc/me.py:73 `_prep_ref`: [H, W] int32 →
    (padded [H+2·PAD, W+2·PAD] edge-replicated, ds4 [⌈H/4⌉, ⌈W/4⌉] the
    floor mean of each 4×4 block of the edge-padded plane)."""
    h, w = plane.shape
    dev = plane.device
    p = plane.to(torch.int32)
    ry = torch.arange(-PAD, h + PAD, device=dev).clamp(0, h - 1)
    rx = torch.arange(-PAD, w + PAD, device=dev).clamp(0, w - 1)
    pp = p[ry][:, rx].contiguous()
    h4, w4 = (h + 3) // 4, (w + 3) // 4
    ey = torch.arange(4 * h4, device=dev).clamp(max=h - 1)
    ex = torch.arange(4 * w4, device=dev).clamp(max=w - 1)
    pe = p[ey][:, ex]
    ds = torch.div(pe.reshape(h4, 4, w4, 4).sum(dim=(1, 3)), 16,
                   rounding_mode="floor").to(torch.int32)
    return pp, ds.contiguous()


def _prep_ref_cuda(plane: torch.Tensor):
    ops.check_cuda_i32("me_prep", plane)
    h, w = plane.shape
    h4, w4 = (h + 3) // 4, (w + 3) // 4
    pp = torch.empty((h + 2 * PAD, w + 2 * PAD), dtype=torch.int32,
                     device=plane.device)
    ds = torch.empty((h4, w4), dtype=torch.int32, device=plane.device)
    fn = ops.lib("me_prep").me_prep_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(plane.data_ptr(), pp.data_ptr(), ds.data_ptr(), h, w, PAD,
             ops.stream_ptr(plane))
    ops.launched("me_prep", err)
    return pp, ds


def prep_ref(plane: torch.Tensor):
    """[H, W] int32 → (padded plane, ds4 plane).  CUDA tensor →
    vvc_torch/csrc/me.cu `me_prep`; CPU tensor or `ops.plain()` →
    prep_ref_plain."""
    if ops.use_kernel(plane):
        return _prep_ref_cuda(plane.contiguous())
    return prep_ref_plain(plane)


_CACHE: dict = {}
_ORDER: list = []


def pic_dev(arr: np.ndarray, device):
    """(padded [H+2P, W+2P], ds4 [⌈H/4⌉, ⌈W/4⌉]) of a reference picture on
    `device`, cached per ndarray object (weakref-validated, 12 entries, as
    vvc's cache: a recon referenced by several B pictures preps once)."""
    dev = torch.device(device)
    key = (id(arr), str(dev))
    ent = _CACHE.get(key)
    if ent is not None and ent[0]() is arr:
        return ent[1], ent[2]
    plane = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.int32)
                             ).to(dev)
    pp, ds = prep_ref(plane)
    _CACHE[key] = (weakref.ref(arr), pp, ds)
    _ORDER.append(key)
    while len(_ORDER) > 12:
        _CACHE.pop(_ORDER.pop(0), None)
    return pp, ds


# --------------------------------------------------------------------
# coarse full search on ds4 planes
# --------------------------------------------------------------------

def _coarse_dims(h4: int, w4: int):
    hp, wp = -(-h4 // 16) * 16, -(-w4 // 16) * 16
    return hp // 4, wp // 4


def _grids_from_args(args, r: int):
    D = 2 * r + 1
    out = {}
    for s, a in zip((16, 32, 64), args):
        out[s] = torch.stack([(a // D - r) * 4, (a % D - r) * 4],
                             dim=-1).to(torch.int32)
    return out


def coarse_search_plain(yds: torch.Tensor, refds: torch.Tensor,
                        r: int = COARSE_R):
    """Plain twin of vvc/enc/me.py:108 `_coarse_program`: yds [h4, w4],
    refds [R, h4, w4] → {16: [R, n4y, n4x, 2], 32: …/2, 64: …/4} int32
    full-pel (mvy, mvx), grids padded to a multiple-of-16 ds extent.  The
    displacement loop runs d = 0..(2r+1)²−1 on the edge-padded refs; each
    4×4 cell's SSE is an exact integer, the bias is added in float32, and
    the 8×8 / 16×16 cells are (a + b) + (c + d) of their four quarters."""
    R, h4, w4 = refds.shape
    dev = refds.device
    D = 2 * r + 1
    n4y, n4x = _coarse_dims(h4, w4)
    bias = coarse_bias_table(r)
    yv = yds.to(torch.int64)
    inf = float("inf")
    best = [torch.full((R, n4y // k, n4x // k), inf, device=dev)
            for k in (1, 2, 4)]
    arg = [torch.zeros((R, n4y // k, n4x // k), dtype=torch.int64,
                       device=dev) for k in (1, 2, 4)]
    ay, ax = torch.arange(h4, device=dev), torch.arange(w4, device=dev)

    def quad(c):
        return ((c[:, 0::2, 0::2] + c[:, 0::2, 1::2])
                + (c[:, 1::2, 0::2] + c[:, 1::2, 1::2]))

    for d in range(D * D):
        dy, dx = d // D - r, d % D - r
        sh = refds[:, (ay + dy).clamp(0, h4 - 1)][:, :, (ax + dx).clamp(
            0, w4 - 1)].to(torch.int64)
        sq = torch.zeros((R, 4 * n4y, 4 * n4x), dtype=torch.int64,
                         device=dev)
        sq[:, :h4, :w4] = (yv[None] - sh) ** 2
        c4 = (sq.reshape(R, n4y, 4, n4x, 4).sum(dim=(2, 4))
              .to(torch.float32) + torch.tensor(bias[d], device=dev))
        c8 = quad(c4)
        c16 = quad(c8)
        for i, c in enumerate((c4, c8, c16)):
            m = c < best[i]
            best[i] = torch.where(m, c, best[i])
            arg[i] = torch.where(m, torch.full_like(arg[i], d), arg[i])
    return _grids_from_args(arg, r)


def _coarse_cuda(yds: torch.Tensor, refds: torch.Tensor, r: int):
    ops.check_cuda_i32("me_coarse", yds, refds)
    if r != COARSE_R:
        raise ValueError("me_coarse: the kernel is built for r = 8")
    R, h4, w4 = refds.shape
    n4y, n4x = _coarse_dims(h4, w4)
    dev = refds.device
    bias = _coarse_bias_dev(str(dev), r)
    outs = [torch.empty((R, n4y // k, n4x // k, 2), dtype=torch.int32,
                        device=dev) for k in (1, 2, 4)]
    fn = ops.lib("me_coarse").me_coarse_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(yds.data_ptr(), refds.data_ptr(), bias.data_ptr(),
             outs[0].data_ptr(), outs[1].data_ptr(), outs[2].data_ptr(),
             R, h4, w4, n4y, n4x, ops.stream_ptr(refds))
    ops.launched("me_coarse", err)
    return dict(zip((16, 32, 64), outs))


@lru_cache(maxsize=None)
def _coarse_bias_dev(device: str, r: int) -> torch.Tensor:
    return torch.from_numpy(coarse_bias_table(r).copy()).to(device)


def coarse_search(yds: torch.Tensor, refds: torch.Tensor,
                  r: int = COARSE_R):
    """Coarse grids for sizes 16, 32, 64.  CUDA tensors →
    vvc_torch/csrc/me.cu `me_coarse`; CPU or `ops.plain()` → the twin."""
    if ops.use_kernel(refds):
        return _coarse_cuda(yds.contiguous(), refds.contiguous(), r)
    return coarse_search_plain(yds, refds, r)


# --------------------------------------------------------------------
# integer refinement in the window
# --------------------------------------------------------------------

def win_centers(cy, cx, ys, xs, h: int, w: int, s: int):
    """vvc/enc/me.py:156 `_win_centers`: clip the coarse centres so the
    (s + 2·WIN_M)² window stays inside the padded plane (jnp.clip is
    min(max(x, lo), hi)); returns (cy, cx, sy, sx), sy/sx the padded
    origins."""
    ws = s + 2 * WIN_M
    cy = torch.minimum(torch.maximum(cy, WIN_M - (ys + PAD)),
                       (h + PAD - ws) - ys + WIN_M)
    cx = torch.minimum(torch.maximum(cx, WIN_M - (xs + PAD)),
                       (w + PAD - ws) - xs + WIN_M)
    return cy, cx, ys + PAD + cy - WIN_M, xs + PAD + cx - WIN_M


def _gather(plane: torch.Tensor, oy, ox, n: int) -> torch.Tensor:
    """[N, n, n] windows of `plane` at origins (oy, ox)."""
    k = torch.arange(n, device=plane.device)
    return plane[(oy[:, None] + k)[:, :, None], (ox[:, None] + k)[:, None, :]]


def int_refine_plain(refpad: torch.Tensor, ob: torch.Tensor, ys, xs, cy, cx,
                     lam_m, s: int, h: int, w: int):
    """Plain twin of vvc's `_win_centers` + `_gather_windows` +
    `_int_refine` (vvc/enc/me.py:150-200): 81 SSE costs in ±R2 around the
    clipped centre, raster order (dy outer), first minimum.  Returns
    (iy, ix, cy, cx) int32 [N]: the integer-pel MV and the clipped
    centre."""
    hp, wp = refpad.shape
    ws = s + 2 * WIN_M
    cy, cx, sy, sx = win_centers(cy, cx, ys, xs, h, w, s)
    # lax.dynamic_slice clamps its start; the clipped centre makes that a
    # no-op
    assert bool(((sy >= 0) & (sy <= hp - ws) & (sx >= 0)
                 & (sx <= wp - ws)).all()), "window start out of bounds"
    win = _gather(refpad, sy, sx, ws).to(torch.int32)
    ob = ob.to(torch.int32)
    lam_m = np.float32(lam_m)
    costs = []
    for dy in range(-R2, R2 + 1):
        by = mv_bits(4 * (cy + dy))
        for dx in range(-R2, R2 + 1):
            t, l = dy + WIN_M, dx + WIN_M
            sse = sse_f32_me(win[:, t:t + s, l:l + s] - ob)
            costs.append(_fma_f32(lam_m, by + mv_bits(4 * (cx + dx)), sse))
    k = torch.argmin(torch.stack(costs, dim=1), dim=1).to(torch.int32)
    n2 = 2 * R2 + 1
    return (cy + k // n2 - R2).to(torch.int32), \
        (cx + k % n2 - R2).to(torch.int32), cy.to(torch.int32), \
        cx.to(torch.int32)


def _int_refine_cuda(refpad, ob, ys, xs, cy, cx, lam_m, s: int, h: int,
                     w: int):
    ops.check_cuda_i32("me_int", refpad, ob, ys, xs, cy, cx)
    n = ob.shape[0]
    if s not in (8, 16, 32, 64) or tuple(ob.shape[1:]) != (s, s):
        raise ValueError(f"me_int: unsupported block {tuple(ob.shape)}")
    dev = ob.device
    outs = [torch.empty(n, dtype=torch.int32, device=dev) for _ in range(4)]
    if n == 0:
        return tuple(outs)
    mvb = _mv_bits_dev(str(dev))
    fn = ops.lib("me_int").me_int_launch
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 2
                   + [ctypes.c_float] + [ctypes.c_int] * 4
                   + [ctypes.c_void_p] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    err = fn(refpad.data_ptr(), ob.data_ptr(), ys.data_ptr(), xs.data_ptr(),
             cy.data_ptr(), cx.data_ptr(), mvb.data_ptr(),
             refpad.shape[0], refpad.shape[1], float(np.float32(lam_m)),
             n, s, h, w, *(o.data_ptr() for o in outs), ops.stream_ptr(ob))
    ops.launched("me_int", err)
    return tuple(outs)


def int_refine(refpad: torch.Tensor, ob: torch.Tensor, ys, xs, cy, cx,
               lam_m, s: int, h: int, w: int):
    """(iy, ix, cy, cx) int32 [N] — see int_refine_plain.  CUDA tensors →
    vvc_torch/csrc/me.cu `me_int`; CPU or `ops.plain()` → the twin."""
    if ops.use_kernel(ob):
        return _int_refine_cuda(*(t.to(torch.int32).contiguous() for t in
                                  (refpad, ob, ys, xs, cy, cx)),
                                lam_m, s, h, w)
    return int_refine_plain(refpad, ob, ys, xs, cy, cx, lam_m, s, h, w)


# --------------------------------------------------------------------
# quarter-pel refinement (normative 8-tap DCTIF, SATD cost)
# --------------------------------------------------------------------

def qpel_refine_plain(refpad: torch.Tensor, ob: torch.Tensor, ys, xs, iy, ix,
                      lam_m, s: int, bit_depth: int):
    """Plain twin of vvc/enc/me.py:203 `_qpel_refine`: the 49 quarter-pel
    offsets in ±3 (qy outer, qx inner) around the integer winner, 8-tap
    DCTIF in int32 (horizontal pass unshifted, or <<6 at fx = 0; vertical
    unshifted, or <<6 at fy = 0; then (acc + 2048) >> 12 and clip), cost
    fma(√λ, bits(mvy) + bits(mvx), SATD), first minimum.  Returns
    (mvy, mvx int32 [N], cost float32 [N], pred int32 [N, s, s])."""
    mx = (1 << bit_depth) - 1
    m2 = s + 2 * M2
    filt = [[int(v) for v in row] for row in LUMA_FILTERS]
    w2 = _gather(refpad, ys + PAD + iy - M2, xs + PAD + ix - M2, m2
                 ).to(torch.int32)
    ob = ob.to(torch.int32)
    lam_m = np.float32(lam_m)
    hor = {}
    for qx in range(-3, 4):
        ixo, fx = qx >> 2, qx & 3
        if (ixo, fx) in hor:
            continue
        if fx == 0:
            hor[(ixo, fx)] = w2[:, :, M2:M2 + s] << 6
        else:
            c0 = ixo + M2 - 3
            acc = torch.zeros((w2.shape[0], m2, s), dtype=torch.int32,
                              device=w2.device)
            for k in range(8):
                acc = acc + filt[fx][k] * w2[:, :, c0 + k:c0 + k + s]
            hor[(ixo, fx)] = acc
    best = None
    for qy in range(-3, 4):
        iyo, fy = qy >> 2, qy & 3
        r0 = iyo + M2 - 3
        for qx in range(-3, 4):
            hb = hor[(qx >> 2, qx & 3)]
            if fy == 0:
                acc = hb[:, M2:M2 + s, :] << 6
            else:
                acc = torch.zeros_like(hb[:, :s, :])
                for k in range(8):
                    acc = acc + filt[fy][k] * hb[:, r0 + k:r0 + k + s, :]
            pred = ((acc + 2048) >> 12).clamp(0, mx)
            mvy, mvx = 4 * iy + qy, 4 * ix + qx
            c = _fma_f32(lam_m, mv_bits(mvy) + mv_bits(mvx),
                        satd_batch_plain(pred, ob).to(torch.float32))
            if best is None:
                best = [c, mvy, mvx, pred]
            else:
                m = c < best[0]
                best = [torch.where(m, c, best[0]),
                        torch.where(m, mvy, best[1]),
                        torch.where(m, mvx, best[2]),
                        torch.where(m[:, None, None], pred, best[3])]
    return (best[1].to(torch.int32), best[2].to(torch.int32), best[0],
            best[3].to(torch.int32))


@lru_cache(maxsize=None)
def _filters_dev(device: str) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(LUMA_FILTERS, dtype=np.int32)
                            ).to(device)


def _qpel_refine_cuda(refpad, ob, ys, xs, iy, ix, lam_m, s: int,
                      bit_depth: int):
    ops.check_cuda_i32("me_qpel", refpad, ob, ys, xs, iy, ix)
    n = ob.shape[0]
    if s not in (8, 16, 32, 64) or tuple(ob.shape[1:]) != (s, s):
        raise ValueError(f"me_qpel: unsupported block {tuple(ob.shape)}")
    dev = ob.device
    mvy = torch.empty(n, dtype=torch.int32, device=dev)
    mvx = torch.empty_like(mvy)
    cost = torch.empty(n, dtype=torch.float32, device=dev)
    pred = torch.empty((n, s, s), dtype=torch.int32, device=dev)
    if n == 0:
        return mvy, mvx, cost, pred
    fn = ops.lib("me_qpel").me_qpel_launch
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 2
                   + [ctypes.c_float] + [ctypes.c_int] * 2
                   + [ctypes.c_void_p] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    err = fn(refpad.data_ptr(), ob.data_ptr(), ys.data_ptr(), xs.data_ptr(),
             iy.data_ptr(), ix.data_ptr(), _mv_bits_dev(str(dev)).data_ptr(),
             refpad.shape[1], n,
             float(np.float32(lam_m)), s, (1 << bit_depth) - 1,
             mvy.data_ptr(), mvx.data_ptr(), cost.data_ptr(), pred.data_ptr(),
             ops.stream_ptr(ob))
    ops.launched("me_qpel", err)
    return mvy, mvx, cost, pred


def qpel_refine(refpad: torch.Tensor, ob: torch.Tensor, ys, xs, iy, ix,
                lam_m, s: int, bit_depth: int):
    """(mvy, mvx, cost, pred) — see qpel_refine_plain.  CUDA tensors →
    vvc_torch/csrc/me.cu `me_qpel`; CPU or `ops.plain()` → the twin."""
    if ops.use_kernel(ob):
        return _qpel_refine_cuda(*(t.to(torch.int32).contiguous() for t in
                                   (refpad, ob, ys, xs, iy, ix)),
                                 lam_m, s, bit_depth)
    return qpel_refine_plain(refpad, ob, ys, xs, iy, ix, lam_m, s, bit_depth)


def eval_ref(refpad: torch.Tensor, ob: torch.Tensor, ys, xs, cy, cx, lam_m,
             s: int, h: int, w: int, bit_depth: int) -> dict:
    """vvc/enc/me.py:261 `eval_ref`: `_win_centers` + `_gather_windows` +
    `_eval_from_win` — the integer refine around the clipped centre
    (`int_refine`, kernel `me_int`), then the quarter-pel refine
    (`qpel_refine`, kernel `me_qpel`).  Returns vvc's dict: mvy, mvx
    (quarter-pel), cost, pred [N, s, s], w2 (the window re-centred on the
    integer winner, [N, s + 2·M2, s + 2·M2]), iy, ix (integer-pel)."""
    iy, ix, _, _ = int_refine(refpad, ob, ys, xs, cy, cx, lam_m, s, h, w)
    mvy, mvx, cost, pred = qpel_refine(refpad, ob, ys, xs, iy, ix, lam_m, s,
                                       bit_depth)
    w2 = _gather(refpad, ys + PAD + iy - M2, xs + PAD + ix - M2,
                 s + 2 * M2).to(torch.int32)
    return dict(mvy=mvy, mvx=mvx, cost=cost, pred=pred, w2=w2, iy=iy, ix=ix)


# --------------------------------------------------------------------
# affine: corner-delta candidate search in the re-centred window
# --------------------------------------------------------------------
#
# vvc/enc/me.py:272 `affine_search_win` scores 49 candidates (da, db) of
# AFF_DELTAS × AFF_DELTAS (da outer), then 8 ±1 steps, each around the
# running best (AFF_STEPS), with a strict `<` (the first minimum wins).  A
# candidate is the field dq(x, y) = (a·cx − b·cy, b·cx + a·cy), a = da/s,
# b = db/s, cx, cy the subblock centre relative to the block centre; each
# 4×4 subblock samples w2 bilinearly at M2 + (q0 + dq)/4.  vvc computes the
# bilinear prediction in float32 with one-hot sums over 13 taps; only two
# taps per pass are non-zero, and every value is exact: |da|, |db| ≤ 16 (8
# on the grid, then 8 unit steps) keep each position a multiple of 1/128
# inside [1.5, 10.5], so the row pass needs 17 bits and the column pass 24.
# The port computes the same values in integers scaled by 128² and rounds
# half to even (jnp.round).  The costs are float32 as XLA-CPU computes them
# (read from the optimised HLO and LLVM IR of vvc's jitted search, jax
# 0.9.0): XLA folds AFFINE_BITS + bits(da) into fma(log(1+|da|), 2/ln 2,
# 19) (`aff_bits_table`) and adds bits(db) = fma(log(1+|db|), 2/ln 2, 1);
# stage 1 scores a scalar candidate, so √λ·X is one product broadcast to
# every block and added apart (two roundings); stage 2's candidates are per
# block and the backend contracts satd + √λ·X into one FMA.

AFF_BITS_N = 64


@lru_cache(maxsize=None)
def aff_bits_table() -> np.ndarray:
    """[AFF_BITS_N] float32: AFFINE_BITS + _mv_bits(d) for |d| = 0..63 as
    XLA computes it, one FMA fma(log(1 + |d|), 2/ln 2, 19) (the float64
    product and sum are exact, so the cast rounds once)."""
    log = xla_log_f32()[:AFF_BITS_N].astype(np.float64)
    val = (log * np.float64(log_scale_f32()) + (AFFINE_BITS + 1.0)
           ).astype(np.float32)
    val.setflags(write=False)
    return val


@lru_cache(maxsize=None)
def _aff_bits_dev(device: str) -> torch.Tensor:
    return torch.from_numpy(aff_bits_table().copy()).to(device)


def aff_cost_bits(da: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """float32 AFFINE_BITS + bits(da) + bits(db), XLA's association."""
    return (_aff_bits_dev(str(da.device))[da.abs().long()]
            + mv_bits(db))


def _cc(s: int, device) -> torch.Tensor:
    """Subblock centres relative to the block centre: 4u + 2 − s/2."""
    return torch.arange(s // 4, device=device, dtype=torch.int64) * 4 + 2 \
        - s // 2


def _aff_num(da, db, s: int):
    """Per-subblock numerators of the candidate field [N, s/4, s/4] (v
    rows, u columns): dqx·s = da·cc_u − db·cc_v, dqy·s = db·cc_u + da·cc_v."""
    cc = _cc(s, da.device)
    da = da.to(torch.int64)[:, None, None]
    db = db.to(torch.int64)[:, None, None]
    cu, cv = cc[None, None, :], cc[None, :, None]
    return da * cu - db * cv, db * cu + da * cv


def _window(refpad: torch.Tensor, ys, xs, iy, ix, s: int) -> torch.Tensor:
    """vvc's re-centred window w2 [N, s + 2·M2, s + 2·M2]."""
    return _gather(refpad, ys + PAD + iy - M2, xs + PAD + ix - M2,
                   s + 2 * M2).to(torch.int64)


def _rne_shift(p: torch.Tensor, k: int) -> torch.Tensor:
    """round(p / 2^k), half to even (jnp.round), for int64 p."""
    q = p >> k
    rem = p - (q << k)
    half = 1 << (k - 1)
    return q + ((rem > half) | ((rem == half) & ((q & 1) == 1))).to(q.dtype)


def _aff_bilinear(w2, q0y, q0x, da, db, s: int, mx: int) -> torch.Tensor:
    """The candidate's bilinear prediction [N, s, s] int32 (vvc's `score`
    before the SATD): exact integers scaled by AFF_SCALE², rounded half to
    even, clipped."""
    n = w2.shape[0]
    numx, numy = _aff_num(da, db, s)
    sc = AFF_SCALE
    # position·128 = M2·128 + 32·q0 + 32·num/s (num is even: exact)
    by = M2 * sc + (sc // 4) * q0y.to(torch.int64)[:, None, None] \
        + (sc // 4) * numy // s
    bx = M2 * sc + (sc // 4) * q0x.to(torch.int64)[:, None, None] \
        + (sc // 4) * numx // s
    # vvc clips the position to [0, 2·M2 − 0.001]; at |da|, |db| ≤ 16 the
    # clip never binds
    assert bool(((by >= 0) & (by < 2 * M2 * sc) & (bx >= 0)
                 & (bx < 2 * M2 * sc)).all()), \
        "affine candidate outside the window (vvc would clip)"
    rep = lambda t: t.repeat_interleave(4, 1).repeat_interleave(4, 2)
    iby, ay = rep(by // sc), rep(by % sc)
    ibx, ax = rep(bx // sc), rep(bx % sc)
    k = torch.arange(s, device=w2.device)
    y0 = k[None, :, None] + iby
    x0 = k[None, None, :] + ibx
    nn = torch.arange(n, device=w2.device)[:, None, None]
    def at(dy, dx):
        return w2[nn, y0 + dy, x0 + dx]
    r0 = (sc - ay) * at(0, 0) + ay * at(1, 0)
    r1 = (sc - ay) * at(0, 1) + ay * at(1, 1)
    p = (sc - ax) * r0 + ax * r1
    return _rne_shift(p, 14).clamp(0, mx).to(torch.int32)


def _dctif_offsets(q0, num, s: int) -> torch.Tensor:
    """clip(round(q0 + num/s), −12, 11) per subblock, half to even."""
    t = q0.to(torch.int64)[:, None, None] * s + num
    q = torch.div(t, s, rounding_mode="floor")
    r2 = 2 * (t - q * s)
    q = q + ((r2 > s) | ((r2 == s) & ((q & 1) == 1))).to(q.dtype)
    return q.clamp(-12, 11).to(torch.int32)


def affine_dctif_pred_plain(refpad: torch.Tensor, ys, xs, iy, ix, qy, qx,
                            s: int, bit_depth: int) -> torch.Tensor:
    """Plain twin of vvc/enc/me.py:374 `_affine_dctif_pred`: the 8-tap
    DCTIF of each 4×4 subblock of w2 at its quarter-pel offsets qy, qx
    [N, s/4, s/4] ∈ [−12, 11] (integer offset q >> 2, phase q & 3), as the
    exact integer sum Σ_t Σ_t' F[fy][t]·F[fx][t']·w2 (below 2^24, so vvc's
    float32 sums are exact), then clip(round(sum / 4096)), half to even →
    [N, s, s] int32."""
    w2 = _window(refpad, ys, xs, iy, ix, s)
    n = w2.shape[0]
    dev = w2.device
    filt = torch.from_numpy(LUMA_FILTERS.astype(np.int64)).to(dev)
    rep = lambda t: t.to(torch.int64).repeat_interleave(4, 1) \
        .repeat_interleave(4, 2)
    qy, qx = rep(qy), rep(qx)
    k = torch.arange(s, device=dev)
    y0 = k[None, :, None] + (qy >> 2) + 3
    x0 = k[None, None, :] + (qx >> 2) + 3
    fy, fx = qy & 3, qx & 3
    nn = torch.arange(n, device=dev)[:, None, None]
    acc = torch.zeros((n, s, s), dtype=torch.int64, device=dev)
    for t in range(8):
        hor = torch.zeros_like(acc)
        for u in range(8):
            hor = hor + filt[fx, u] * w2[nn, y0 + t, x0 + u]
        acc = acc + filt[fy, t] * hor
    return _rne_shift(acc, 12).clamp(0, (1 << bit_depth) - 1).to(
        torch.int32)


def _dctif_cuda(refpad, ys, xs, iy, ix, qy, qx, s: int, bit_depth: int):
    ops.check_cuda_i32("affine_dctif", refpad, ys, xs, iy, ix, qy, qx)
    n = ys.shape[0]
    if s not in AFFINE_ME_SIZES or tuple(qy.shape) != (n, s // 4, s // 4):
        raise ValueError(f"affine_dctif: unsupported field {tuple(qy.shape)}")
    pred = torch.empty((n, s, s), dtype=torch.int32, device=ys.device)
    if n == 0:
        return pred
    fn = ops.lib("affine_dctif").affine_dctif_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(refpad.data_ptr(), ys.data_ptr(), xs.data_ptr(), iy.data_ptr(),
             ix.data_ptr(), qy.data_ptr(), qx.data_ptr(),
             _filters_dev(str(ys.device)).data_ptr(), refpad.shape[1], n, s,
             (1 << bit_depth) - 1, pred.data_ptr(), ops.stream_ptr(ys))
    ops.launched("affine_dctif", err)
    return pred


def affine_dctif_pred(refpad: torch.Tensor, ys, xs, iy, ix, qy, qx, s: int,
                      bit_depth: int) -> torch.Tensor:
    """[N, s, s] int32 — see affine_dctif_pred_plain.  CUDA tensors →
    vvc_torch/csrc/affine.cu `affine_dctif`; CPU or `ops.plain()` → the
    twin."""
    if ops.use_kernel(ys):
        return _dctif_cuda(*(t.to(torch.int32).contiguous() for t in
                             (refpad, ys, xs, iy, ix, qy, qx)), s, bit_depth)
    return affine_dctif_pred_plain(refpad, ys, xs, iy, ix, qy, qx, s,
                                   bit_depth)


def affine_fields_plain(refpad: torch.Tensor, ob: torch.Tensor, ys, xs,
                        mvy0, mvx0, iy, ix, lam_m, s: int, bit_depth: int):
    """The search of `affine_search_plain` without the final prediction:
    (cost float32 [N], da, db int32 [N], qy, qx int32 [N, s/4, s/4]), the
    winner's DCTIF offsets."""
    if s not in AFFINE_ME_SIZES:
        raise ValueError(f"affine search at size {s}")
    n = ob.shape[0]
    dev = ob.device
    mx = (1 << bit_depth) - 1
    w2 = _window(refpad, ys, xs, iy, ix, s)
    q0y, q0x = mvy0 - 4 * iy, mvx0 - 4 * ix
    lam = np.float32(lam_m)
    lam_t = torch.tensor(lam, dtype=torch.float32, device=dev)
    ob = ob.to(torch.int32)

    def satd_of(da, db):
        pred = _aff_bilinear(w2, q0y, q0x, da, db, s, mx)
        return satd_batch_plain(pred, ob).to(torch.float32)

    best_c = torch.full((n,), float("inf"), device=dev)
    best_a = torch.zeros(n, dtype=torch.int64, device=dev)
    best_b = torch.zeros_like(best_a)
    for da in AFF_DELTAS:
        for db in AFF_DELTAS:
            ca = torch.full((n,), da, dtype=torch.int64, device=dev)
            cb = torch.full((n,), db, dtype=torch.int64, device=dev)
            # √λ·X is one scalar product, added apart
            c = satd_of(ca, cb) + lam_t * aff_cost_bits(ca[:1], cb[:1])
            m = c < best_c
            best_c = torch.where(m, c, best_c)
            best_a = torch.where(m, ca, best_a)
            best_b = torch.where(m, cb, best_b)
    for oa, ob_ in AFF_STEPS:
        ca, cb = best_a + oa, best_b + ob_
        c = _fma_f32(lam, aff_cost_bits(ca, cb), satd_of(ca, cb))
        m = c < best_c
        best_c = torch.where(m, c, best_c)
        best_a = torch.where(m, ca, best_a)
        best_b = torch.where(m, cb, best_b)
    numx, numy = _aff_num(best_a, best_b, s)
    return (best_c, best_a.to(torch.int32), best_b.to(torch.int32),
            _dctif_offsets(q0y, numy, s), _dctif_offsets(q0x, numx, s))


def affine_search_plain(refpad: torch.Tensor, ob: torch.Tensor, ys, xs,
                        mvy0, mvx0, iy, ix, lam_m, s: int, bit_depth: int):
    """Plain twin of vvc/enc/me.py:272 `affine_search_win` (w2 read from
    the padded reference at the integer winner (iy, ix); (mvy0, mvx0) the
    quarter-pel translational seed).  Returns (cost float32 [N], da, db
    int32 [N], pred int32 [N, s, s]): the bilinear search's best cost and
    corner deltas, and the winner's DCTIF prediction."""
    cost, da, db, qy, qx = affine_fields_plain(
        refpad, ob, ys, xs, mvy0, mvx0, iy, ix, lam_m, s, bit_depth)
    pred = affine_dctif_pred_plain(refpad, ys, xs, iy, ix, qy, qx, s,
                                   bit_depth)
    return cost, da, db, pred


def _affine_fields_cuda(refpad, ob, ys, xs, mvy0, mvx0, iy, ix, lam_m,
                        s: int, bit_depth: int):
    ops.check_cuda_i32("affine_search", refpad, ob, ys, xs, mvy0, mvx0, iy,
                       ix)
    n = ob.shape[0]
    if s not in AFFINE_ME_SIZES or tuple(ob.shape[1:]) != (s, s):
        raise ValueError(f"affine_search: unsupported block "
                         f"{tuple(ob.shape)}")
    dev = ob.device
    cost = torch.empty(n, dtype=torch.float32, device=dev)
    da = torch.empty(n, dtype=torch.int32, device=dev)
    db = torch.empty_like(da)
    qy = torch.empty((n, s // 4, s // 4), dtype=torch.int32, device=dev)
    qx = torch.empty_like(qy)
    if n == 0:
        return cost, da, db, qy, qx
    fn = ops.lib("affine_search").affine_search_launch
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 2
                   + [ctypes.c_float] + [ctypes.c_int] * 2
                   + [ctypes.c_void_p] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    err = fn(refpad.data_ptr(), ob.data_ptr(), ys.data_ptr(), xs.data_ptr(),
             mvy0.data_ptr(), mvx0.data_ptr(), iy.data_ptr(), ix.data_ptr(),
             _aff_bits_dev(str(dev)).data_ptr(),
             _mv_bits_dev(str(dev)).data_ptr(), refpad.shape[1], n,
             float(np.float32(lam_m)), s, (1 << bit_depth) - 1,
             cost.data_ptr(), da.data_ptr(), db.data_ptr(), qy.data_ptr(),
             qx.data_ptr(), ops.stream_ptr(ob))
    ops.launched("affine_search", err)
    return cost, da, db, qy, qx


def affine_fields(refpad: torch.Tensor, ob: torch.Tensor, ys, xs, mvy0,
                  mvx0, iy, ix, lam_m, s: int, bit_depth: int):
    """(cost, da, db, qy, qx) — see affine_fields_plain.  CUDA tensors →
    vvc_torch/csrc/affine.cu `affine_search`; CPU or `ops.plain()` → the
    twin."""
    if ops.use_kernel(ob):
        return _affine_fields_cuda(*(t.to(torch.int32).contiguous() for t in
                                     (refpad, ob, ys, xs, mvy0, mvx0, iy,
                                      ix)), lam_m, s, bit_depth)
    return affine_fields_plain(refpad, ob, ys, xs, mvy0, mvx0, iy, ix,
                               lam_m, s, bit_depth)


def affine_search(refpad: torch.Tensor, ob: torch.Tensor, ys, xs, mvy0,
                  mvx0, iy, ix, lam_m, s: int, bit_depth: int):
    """(cost, da, db, pred) — see affine_search_plain: the search
    (`affine_fields`), then the winner's prediction
    (`affine_dctif_pred`)."""
    cost, da, db, qy, qx = affine_fields(refpad, ob, ys, xs, mvy0, mvx0, iy,
                                         ix, lam_m, s, bit_depth)
    return cost, da, db, affine_dctif_pred(refpad, ys, xs, iy, ix, qy, qx, s,
                                           bit_depth)


# --------------------------------------------------------------------
# standalone ME + prediction (MCTF consumer) on the window engine
# --------------------------------------------------------------------

MCTF_BLOCK = 16


def raster_blocks(plane, nby: int, nbx: int, s: int):
    """The nby × nbx s×s blocks of a plane's top-left corner, raster order
    → [nby·nbx, s, s]."""
    return (plane[:nby * s, :nbx * s].reshape(nby, s, nbx, s)
            .permute(0, 2, 1, 3).reshape(-1, s, s).contiguous())


def block_err_plain(pred: torch.Tensor, cur: torch.Tensor, ny: int, nx: int):
    """Plain twin of the tail of vvc/enc/me.py:423 `me_pred_v2`: pred
    [ny·nx, 16, 16] (raster blocks) and cur [H, W] → (the prediction plane
    [ny·16, nx·16] int32, err [ny, nx] float32 = mean((pred − cur)²)).
    vvc's float32 sum runs per row: the running total joins lane 0 of 8
    lanes, the row's two parts of 8 are added lane-wise, then the halving
    tree (read from the LLVM IR and the x86 object code of its program; the
    default order of `xla_block_sum`); exact below 2^24.  The mean is the
    exact product by 1/256."""
    s = MCTF_BLOCK
    blocks = raster_blocks(cur, ny, nx, s).to(torch.int32)
    d = (pred.to(torch.int32) - blocks).to(torch.float32)
    err = xla_block_sum(d * d) * np.float32(1.0 / (s * s))
    plane = (pred.reshape(ny, nx, s, s).permute(0, 2, 1, 3)
             .reshape(ny * s, nx * s).to(torch.int32))
    return plane, err.reshape(ny, nx)


def _block_err_cuda(pred: torch.Tensor, cur: torch.Tensor, ny: int, nx: int):
    ops.check_cuda_i32("me_block_err", pred, cur)
    s = MCTF_BLOCK
    if tuple(pred.shape) != (ny * nx, s, s):
        raise ValueError(f"me_block_err: pred {tuple(pred.shape)}")
    plane = torch.empty((ny * s, nx * s), dtype=torch.int32,
                        device=pred.device)
    err = torch.empty((ny, nx), dtype=torch.float32, device=pred.device)
    if ny * nx == 0:
        return plane, err
    fn = ops.lib("me_block_err").me_block_err_launch
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    rc = fn(pred.data_ptr(), cur.data_ptr(), cur.shape[1], ny, nx,
            plane.data_ptr(), err.data_ptr(), ops.stream_ptr(pred))
    ops.launched("me_block_err", rc)
    return plane, err


def block_err(pred: torch.Tensor, cur: torch.Tensor, ny: int, nx: int):
    """(plane, err) — see block_err_plain.  CUDA tensors →
    vvc_torch/csrc/me.cu `me_block_err`; CPU or `ops.plain()` → the
    twin."""
    if ops.use_kernel(pred):
        return _block_err_cuda(pred.to(torch.int32).contiguous(),
                               cur.to(torch.int32).contiguous(), ny, nx)
    return block_err_plain(pred, cur, ny, nx)


def me_pred_v2(cur: torch.Tensor, refpad: torch.Tensor, coarse16, w: int,
               h: int, bit_depth: int, lam_m):
    """vvc/enc/me.py:423 `me_pred_v2`: the 16×16 window search of one
    reference (integer refine, kernel `me_int`; quarter-pel refine, kernel
    `me_qpel`) at the coarse grid's centres, then the prediction plane and
    the per-block MSE (kernel `me_block_err`).  cur [H, W] int32, refpad
    the PAD-padded reference, coarse16 [nc_y, nc_x, 2] full-pel (mvy, mvx).
    Returns (plane [ny·16, nx·16] int32, err [ny, nx] float32)."""
    s = MCTF_BLOCK
    dev = cur.device
    ny, nx = h // s, w // s
    ob = raster_blocks(cur, ny, nx, s).to(torch.int32)
    xs = (torch.arange(nx, device=dev, dtype=torch.int32) * s).repeat(ny)
    ys = (torch.arange(ny, device=dev, dtype=torch.int32) * s
          ).repeat_interleave(nx)
    giy = torch.arange(ny, device=dev).repeat_interleave(nx).clamp(
        max=coarse16.shape[0] - 1)
    gix = torch.arange(nx, device=dev).repeat(ny).clamp(
        max=coarse16.shape[1] - 1)
    iy, ix, _, _ = int_refine(refpad, ob, ys, xs, coarse16[giy, gix, 0],
                              coarse16[giy, gix, 1], lam_m, s, h, w)
    _, _, _, pred = qpel_refine(refpad, ob, ys, xs, iy, ix, lam_m, s,
                                bit_depth)
    return block_err(pred, cur, ny, nx)

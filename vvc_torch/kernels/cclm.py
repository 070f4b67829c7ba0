"""CCLM — cross-component linear model chroma prediction.

TPU-native analog of the reference's CCLM
(`VTM/source/Lib/CommonLib/IntraPrediction.cpp` →
predIntraChromaLM / xGetLumaRecPixels (6-tap 4:2:0 downsample) and the
min/max model derivation).  SURVEY.md §2.2: "CCLM = reduction + per-block
affine".

Model: chroma = clip( (α · lumaDS) >> SHIFT + β ) with (α, β) derived
from up to 4 (lumaDS, chroma) neighbour pairs — the two smallest-luma and
two largest-luma points (spec 8.4.5.2.13 method).  [verify]: the spec
computes the division through a 16-entry LUT; we use exact integer
division (self-consistent between encoder and decoder).  Variants
(chroma_mode): 1 = LM (both sides), 2 = LM_L (left-only derivation),
3 = LM_T (top-only) — reference MDLM_L/MDLM_T, simplified to the block's
own boundary extent ([verify] spec extends the boundary to 2x).

The 6-tap downsampled luma plane is computed vectorized once per call
site; the C++ recon core mirrors the same per-sample formula bit-exactly.

The numpy functions (`luma_ds_region`, `gather_model_points`,
`derive_model`, `predict_cclm`) are the recon oracle's, per leaf;
`luma_ds_plane` and `derive_models_batch` serve the host chroma decision
of inter pictures (vvc/enc/encoder.py `_decide_chroma_modes`).  The RD
search's device chroma decision uses `luma_ds_plane_dev` and
`derive_models_batch_dev` (ports of vvc/kernels/cclm.py:173,187): on a
CUDA tensor they launch the kernels of vvc_torch/csrc/cclm.cu, on a CPU
tensor or inside `ops.plain()` they run their plain PyTorch twins.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from vvc_torch import ops

CCLM_SHIFT = 13


def luma_ds_plane(luma: np.ndarray) -> np.ndarray:
    """[H,W] luma → [H/2, W/2] 6-tap {1,2,1;1,2,1}/8 downsample,
    edge-clamped columns."""
    h, w = luma.shape
    l = luma.astype(np.int32)
    xm = np.clip(np.arange(0, w, 2) - 1, 0, w - 1)
    x0 = np.arange(0, w, 2)
    xp = np.clip(np.arange(0, w, 2) + 1, 0, w - 1)
    r0 = l[0::2]
    r1 = l[1::2] if h % 2 == 0 else np.vstack([l[1::2], l[-1:]])
    return ((r0[:, xm] + 2 * r0[:, x0] + r0[:, xp]
             + r1[:, xm] + 2 * r1[:, x0] + r1[:, xp] + 4) >> 3)


def luma_ds_region(luma: np.ndarray, cx0: int, cy0: int, cw: int,
                   ch: int) -> np.ndarray:
    """The 6-tap downsample of a region: the [ch, cw] downsampled patch
    whose top-left is chroma position (cx0, cy0).  Lets the sequential
    recon refresh only a leaf's neighbourhood instead of re-downsampling
    the whole plane per CCLM leaf (O(leaf) instead of O(frame))."""
    h, w = luma.shape
    l = luma.astype(np.int32)
    cx = np.arange(cx0, cx0 + cw)
    xm = np.clip(2 * cx - 1, 0, w - 1)
    x0 = np.clip(2 * cx, 0, w - 1)
    xp = np.clip(2 * cx + 1, 0, w - 1)
    cy = np.arange(cy0, cy0 + ch)
    y0 = np.clip(2 * cy, 0, h - 1)
    y1 = np.clip(2 * cy + 1, 0, h - 1)
    r0 = l[y0]
    r1 = l[y1]
    return ((r0[:, xm] + 2 * r0[:, x0] + r0[:, xp]
             + r1[:, xm] + 2 * r1[:, x0] + r1[:, xp] + 4) >> 3)


def gather_model_points(ds: np.ndarray, chroma: np.ndarray, coded_c,
                        cx0: int, cy0: int, cs: int, log2_unit=2,
                        variant: int = 1):
    """Up to 4 (lumaDS, chroma) neighbour pairs for a chroma block.
    variant: 1 = LM (both sides), 2 = LM_L (left only), 3 = LM_T (top
    only)."""
    ch, cw = chroma.shape
    pts = []

    def avail(px, py):
        return (0 <= px < cw and 0 <= py < ch
                and bool(coded_c[py >> log2_unit, px >> log2_unit]))

    top_ok = (cy0 > 0 and avail(cx0, cy0 - 1)) and variant != 2
    left_ok = (cx0 > 0 and avail(cx0 - 1, cy0)) and variant != 3
    if top_ok and left_ok:
        xs = [cx0 + cs // 4, cx0 + (3 * cs) // 4]
        ys = [cy0 + cs // 4, cy0 + (3 * cs) // 4]
    elif top_ok:
        xs = [cx0 + k * cs // 4 for k in range(4)]
        ys = []
    elif left_ok:
        xs = []
        ys = [cy0 + k * cs // 4 for k in range(4)]
    else:
        return []
    for x in xs:
        x = min(x, cw - 1)
        if avail(x, cy0 - 1):
            pts.append((int(ds[cy0 - 1, x]), int(chroma[cy0 - 1, x])))
    for y in ys:
        y = min(y, ch - 1)
        if avail(cx0 - 1, y):
            pts.append((int(ds[y, cx0 - 1]), int(chroma[y, cx0 - 1])))
    return pts[:4]


def derive_model(pts, bit_depth: int):
    """(α fixed-point CCLM_SHIFT, β) from sample pairs (min/max method)."""
    if not pts:
        return 0, 1 << (bit_depth - 1)
    while len(pts) < 4:
        pts = pts + pts
    pts = sorted(pts[:4], key=lambda p: p[0])
    lmin = (pts[0][0] + pts[1][0] + 1) >> 1
    lmax = (pts[2][0] + pts[3][0] + 1) >> 1
    cmin = (pts[0][1] + pts[1][1] + 1) >> 1
    cmax = (pts[2][1] + pts[3][1] + 1) >> 1
    if lmax == lmin:
        return 0, cmin
    num = (cmax - cmin) << CCLM_SHIFT
    den = lmax - lmin
    # floor division toward -inf on both sides (python // semantics; the
    # C++ core reproduces this explicitly)
    alpha = num // den
    alpha = max(-(1 << 17), min((1 << 17) - 1, alpha))
    beta = cmin - ((alpha * lmin) >> CCLM_SHIFT)
    return alpha, beta


def derive_models_batch(ds: np.ndarray, chroma: np.ndarray,
                        xs: np.ndarray, ys: np.ndarray, cs: int,
                        bit_depth: int, variant: int = 1):
    """Vectorized (α, β) for N same-size chroma blocks, assuming all
    inside-frame neighbours available (the encoder's orig-domain decision
    approximation — reconstruction re-derives exactly per leaf).

    Returns int64 [N, 2] (alpha, beta)."""
    n = len(xs)
    ch, cw = chroma.shape
    top_ok = (ys > 0) & (variant != 2)
    left_ok = (xs > 0) & (variant != 3)
    # 4 sample points per block: both → 2 top + 2 left; top-only → 4 top;
    # left-only → 4 left (mirrors gather_model_points)
    k = np.arange(4)
    x_top = np.where(top_ok[:, None] & left_ok[:, None],
                     xs[:, None] + np.array([cs // 4, 3 * cs // 4,
                                             cs // 4, 3 * cs // 4]),
                     xs[:, None] + k[None, :] * cs // 4)
    y_left = np.where(top_ok[:, None] & left_ok[:, None],
                      ys[:, None] + np.array([0, 0, cs // 4, 3 * cs // 4]),
                      ys[:, None] + k[None, :] * cs // 4)
    # per point: from top row (y-1, x_top) or left col (x-1, y_left)
    use_top = np.where((top_ok & left_ok)[:, None],
                       np.array([1, 1, 0, 0], dtype=bool)[None, :],
                       np.broadcast_to(top_ok[:, None], (n, 4)))
    px = np.where(use_top, np.minimum(x_top, cw - 1),
                  np.maximum(xs - 1, 0)[:, None])
    py = np.where(use_top, np.maximum(ys - 1, 0)[:, None],
                  np.minimum(y_left, ch - 1))
    lum = ds[py, px].astype(np.int64)
    chr_ = chroma[py, px].astype(np.int64)
    order = np.argsort(lum, axis=1, kind="stable")
    lum = np.take_along_axis(lum, order, axis=1)
    chr_ = np.take_along_axis(chr_, order, axis=1)
    lmin = (lum[:, 0] + lum[:, 1] + 1) >> 1
    lmax = (lum[:, 2] + lum[:, 3] + 1) >> 1
    cmin = (chr_[:, 0] + chr_[:, 1] + 1) >> 1
    cmax = (chr_[:, 2] + chr_[:, 3] + 1) >> 1
    den = lmax - lmin
    alpha = np.where(den != 0,
                     ((cmax - cmin) << CCLM_SHIFT) // np.maximum(den, 1), 0)
    alpha = np.clip(alpha, -(1 << 17), (1 << 17) - 1)
    beta = np.where(den != 0, cmin - ((alpha * lmin) >> CCLM_SHIFT), cmin)
    none_ok = ~top_ok & ~left_ok
    alpha = np.where(none_ok, 0, alpha)
    beta = np.where(none_ok, 1 << (bit_depth - 1), beta)
    return np.stack([alpha, beta], axis=1)


def luma_ds_plane_plain(luma: torch.Tensor) -> torch.Tensor:
    """Plain twin of vvc/kernels/cclm.py:173 luma_ds_plane_jnp (even H)."""
    h, w = luma.shape
    dev = luma.device
    l = luma.to(torch.int32)
    x0 = torch.arange(0, w, 2, device=dev)
    xm = (x0 - 1).clamp(0, w - 1)
    xp = (x0 + 1).clamp(0, w - 1)
    r0 = l[0::2]
    r1 = l[1::2]
    return ((r0[:, xm] + 2 * r0[:, x0] + r0[:, xp]
             + r1[:, xm] + 2 * r1[:, x0] + r1[:, xp] + 4) >> 3)


def _luma_ds_cuda(luma: torch.Tensor) -> torch.Tensor:
    ops.check_cuda_i32("luma_ds", luma)
    h, w = luma.shape
    if h % 2 or w % 2:
        raise ValueError(f"luma_ds: plane {h}x{w} is not of even size")
    out = torch.empty((h // 2, w // 2), dtype=torch.int32,
                      device=luma.device)
    if out.numel() == 0:
        return out
    fn = ops.lib("luma_ds").luma_ds_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(luma.data_ptr(), h, w, out.data_ptr(), ops.stream_ptr(luma))
    ops.launched("luma_ds", err)
    return out


def luma_ds_plane_dev(luma: torch.Tensor) -> torch.Tensor:
    """[H,W] int32 luma → [H/2,W/2] int32, the 6-tap {1,2,1;1,2,1}
    downsample with `(+4) >> 3` and edge-clamped columns.  CUDA tensor →
    csrc/cclm.cu `luma_ds`; CPU tensor or `ops.plain()` → the twin."""
    if ops.use_kernel(luma):
        return _luma_ds_cuda(luma)
    return luma_ds_plane_plain(luma)


def _model_points(xs, ys, cs: int, ch: int, cw: int, variant: int):
    """(px, py [N,4] int64, top_ok, left_ok [N] bool): the 4 neighbour
    positions of each block, as vvc's derive_models_batch_jnp picks them."""
    dev = xs.device
    xs = xs.long()
    ys = ys.long()
    top_ok = (ys > 0) & (variant != 2)
    left_ok = (xs > 0) & (variant != 3)
    k = torch.arange(4, device=dev)
    both = (top_ok & left_ok)[:, None]
    q = cs // 4
    x_top = torch.where(both, xs[:, None] + torch.tensor(
        [q, 3 * cs // 4, q, 3 * cs // 4], device=dev),
        xs[:, None] + k[None, :] * cs // 4)
    y_left = torch.where(both, ys[:, None] + torch.tensor(
        [0, 0, q, 3 * cs // 4], device=dev),
        ys[:, None] + k[None, :] * cs // 4)
    use_top = torch.where(both, torch.tensor([True, True, False, False],
                                             device=dev)[None, :],
                          top_ok[:, None].expand(-1, 4))
    px = torch.where(use_top, x_top.clamp(max=cw - 1),
                     (xs - 1).clamp(min=0)[:, None])
    py = torch.where(use_top, (ys - 1).clamp(min=0)[:, None],
                     y_left.clamp(max=ch - 1))
    return px, py, top_ok, left_ok


def derive_models_batch_plain(ds: torch.Tensor, chroma: torch.Tensor,
                              xs: torch.Tensor, ys: torch.Tensor, cs: int,
                              bit_depth: int, variant: int = 1):
    """Plain twin of vvc/kernels/cclm.py:187 derive_models_batch_jnp →
    (α [N] int32, β [N] int32).  int32 arithmetic as in jnp: a stable sort
    of the 4 luma values (ties keep their order), floor division of a
    numerator that can be negative, arithmetic right shifts."""
    ch, cw = chroma.shape
    px, py, top_ok, left_ok = _model_points(xs, ys, cs, ch, cw, variant)
    lum = ds[py, px].to(torch.int32)
    chr_ = chroma[py, px].to(torch.int32)
    order = torch.sort(lum, dim=1, stable=True).indices
    lum = lum.gather(1, order)
    chr_ = chr_.gather(1, order)
    lmin = (lum[:, 0] + lum[:, 1] + 1) >> 1
    lmax = (lum[:, 2] + lum[:, 3] + 1) >> 1
    cmin = (chr_[:, 0] + chr_[:, 1] + 1) >> 1
    cmax = (chr_[:, 2] + chr_[:, 3] + 1) >> 1
    den = lmax - lmin
    alpha = torch.where(den != 0, torch.div(
        (cmax - cmin) << CCLM_SHIFT, den.clamp(min=1), rounding_mode="floor"),
        0)
    alpha = alpha.clamp(-(1 << 17), (1 << 17) - 1)
    beta = torch.where(den != 0, cmin - ((alpha * lmin) >> CCLM_SHIFT), cmin)
    none_ok = ~top_ok & ~left_ok
    alpha = torch.where(none_ok, 0, alpha)
    beta = torch.where(none_ok, 1 << (bit_depth - 1), beta)
    return alpha.to(torch.int32), beta.to(torch.int32)


def _models_cuda(ds, chroma, xs, ys, cs: int, bit_depth: int, variant: int):
    ops.check_cuda_i32("cclm_models", ds, chroma, xs, ys)
    ch, cw = chroma.shape
    if ds.shape != chroma.shape:
        raise ValueError("cclm_models: ds and chroma planes differ in shape")
    n = xs.shape[0]
    if ys.shape != (n,) or variant not in (1, 2, 3) or cs < 4:
        raise ValueError("cclm_models: bad positions, variant or size")
    alpha = torch.empty((n,), dtype=torch.int32, device=ds.device)
    beta = torch.empty_like(alpha)
    if n == 0:
        return alpha, beta
    fn = ops.lib("cclm_models").cclm_models_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    err = fn(ds.data_ptr(), chroma.data_ptr(), xs.data_ptr(), ys.data_ptr(),
             n, ch, cw, cs, bit_depth, variant, alpha.data_ptr(),
             beta.data_ptr(), ops.stream_ptr(ds))
    ops.launched("cclm_models", err)
    return alpha, beta


def derive_models_batch_dev(ds: torch.Tensor, chroma: torch.Tensor,
                            xs: torch.Tensor, ys: torch.Tensor, cs: int,
                            bit_depth: int, variant: int = 1):
    """(α, β) [N] int32 of the CCLM model `variant` (1 LM, 2 LM_L, 3 LM_T)
    for N chroma blocks of size cs at (xs, ys), from the downsampled luma
    `ds` and the chroma plane (same [H/2,W/2] shape), all neighbours inside
    the plane taken as available.  CUDA tensor → csrc/cclm.cu
    `cclm_models`; CPU tensor or `ops.plain()` → the twin."""
    if ops.use_kernel(ds):
        return _models_cuda(ds, chroma, xs, ys, cs, bit_depth, variant)
    return derive_models_batch_plain(ds, chroma, xs, ys, cs, bit_depth,
                                     variant)


def predict_cclm(ds: np.ndarray, chroma: np.ndarray, coded_c, cx0: int,
                 cy0: int, cs: int, bit_depth: int, log2_unit=2,
                 variant: int = 1):
    """CCLM prediction for one chroma block from the downsampled-luma
    plane `ds` (numpy oracle)."""
    pts = gather_model_points(ds, chroma, coded_c, cx0, cy0, cs, log2_unit,
                              variant)
    alpha, beta = derive_model(pts, bit_depth)
    blk = ds[cy0:cy0 + cs, cx0:cx0 + cs].astype(np.int64)
    pred = (alpha * blk >> CCLM_SHIFT) + beta
    return np.clip(pred, 0, (1 << bit_depth) - 1).astype(np.int32)


# ---------------------------------------------------------------------------
# The decoder's CCLM: the chroma leaves of one wave, with the model points
# of gather_model_points under z-order availability
# ---------------------------------------------------------------------------


def predict_cclm_wave_plain(ds: torch.Tensor, chroma: torch.Tensor,
                            order_map: torch.Tensor, xs: torch.Tensor,
                            ys: torch.Tensor, zis: torch.Tensor,
                            variants: torch.Tensor, cs: int, bit_depth: int,
                            pred: torch.Tensor) -> torch.Tensor:
    """Plain twin of the `wave_cclm` kernel: predict_cclm for every leaf
    whose variant is not 0, written into pred [N, cs, cs] in place (the
    other leaves' rows are left as they are); returns pred."""
    sel = torch.nonzero(variants != 0).flatten()
    if sel.numel() == 0:
        return pred
    ch, cw = chroma.shape
    dev = chroma.device
    x0, y0 = xs[sel].long(), ys[sel].long()
    zi, var = zis[sel].long(), variants[sel].long()
    n = sel.numel()

    def avail(px, py):
        inside = (px >= 0) & (px < cw) & (py >= 0) & (py < ch)
        o = order_map[py.clamp(0, ch - 1) >> 2, px.clamp(0, cw - 1) >> 2]
        return inside & (o < zi.view(-1, *([1] * (px.dim() - 1))))

    top_ok = (y0 > 0) & avail(x0, y0 - 1) & (var != 2)
    left_ok = (x0 > 0) & avail(x0 - 1, y0) & (var != 3)
    both = (top_ok & left_ok)[:, None]
    k = torch.arange(4, device=dev)
    p = torch.where(both, torch.tensor([cs // 4, 3 * cs // 4] * 2,
                                       device=dev)[None, :],
                    k[None, :] * cs // 4)
    top = torch.where(both, k[None, :] < 2, top_ok[:, None].expand(n, 4))
    px = torch.where(top, (x0[:, None] + p).clamp(max=cw - 1),
                     (x0 - 1)[:, None])
    py = torch.where(top, (y0 - 1)[:, None],
                     (y0[:, None] + p).clamp(max=ch - 1))
    ok = avail(px, py) & (top_ok | left_ok)[:, None]
    cnt = ok.sum(1)
    # the available points first, in order; point j of four is j mod count
    rank = torch.where(ok, k[None, :], 4 + k[None, :]).argsort(dim=1)
    pick = rank.gather(1, k[None, :] % cnt.clamp(min=1)[:, None])
    qx, qy = px.gather(1, pick), py.gather(1, pick)
    qy_c, qx_c = qy.clamp(0, ch - 1), qx.clamp(0, cw - 1)
    lum = ds[qy_c, qx_c].to(torch.int32)
    chr_ = chroma[qy_c, qx_c].to(torch.int32)
    order = torch.sort(lum, dim=1, stable=True).indices
    lum, chr_ = lum.gather(1, order), chr_.gather(1, order)
    lmin = (lum[:, 0] + lum[:, 1] + 1) >> 1
    lmax = (lum[:, 2] + lum[:, 3] + 1) >> 1
    cmin = (chr_[:, 0] + chr_[:, 1] + 1) >> 1
    cmax = (chr_[:, 2] + chr_[:, 3] + 1) >> 1
    den = lmax - lmin
    alpha = torch.where(den != 0, torch.div(
        (cmax - cmin) << CCLM_SHIFT, den.clamp(min=1), rounding_mode="floor"),
        0).clamp(-(1 << 17), (1 << 17) - 1)
    beta = torch.where(den != 0, cmin - ((alpha * lmin) >> CCLM_SHIFT), cmin)
    alpha = torch.where(cnt == 0, 0, alpha).long()
    beta = torch.where(cnt == 0, 1 << (bit_depth - 1), beta).long()
    r = torch.arange(cs, device=dev)
    blk = ds[(y0[:, None] + r)[:, :, None], (x0[:, None] + r)[:, None, :]]
    out = ((alpha[:, None, None] * blk.long()) >> CCLM_SHIFT) \
        + beta[:, None, None]
    pred[sel] = out.clamp(0, (1 << bit_depth) - 1).to(pred.dtype)
    return pred


def _cclm_wave_cuda(ds, chroma, order_map, xs, ys, zis, variants, cs: int,
                    bit_depth: int, pred) -> torch.Tensor:
    ops.check_cuda_i32("wave_cclm", ds, chroma, order_map, xs, ys, zis,
                       variants, pred)
    ch, cw = chroma.shape
    n = xs.shape[0]
    if ds.shape != chroma.shape or order_map.shape != ((ch + 3) >> 2,
                                                       (cw + 3) >> 2):
        raise ValueError("wave_cclm: ds, chroma and order map differ")
    if (pred.shape != (n, cs, cs) or variants.shape != (n,)
            or not 4 <= cs <= 32):
        raise ValueError("wave_cclm: bad leaves, variants or size")
    if n == 0:
        return pred
    fn = ops.lib("wave_cclm").wave_cclm_launch
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    err = fn(ds.data_ptr(), chroma.data_ptr(), ch, cw, order_map.data_ptr(),
             order_map.shape[1], xs.data_ptr(), ys.data_ptr(),
             zis.data_ptr(), variants.data_ptr(), n, cs, bit_depth,
             pred.data_ptr(), ops.stream_ptr(ds))
    ops.launched("wave_cclm", err)
    return pred


def predict_cclm_wave(ds: torch.Tensor, chroma: torch.Tensor,
                      order_map: torch.Tensor, xs: torch.Tensor,
                      ys: torch.Tensor, zis: torch.Tensor,
                      variants: torch.Tensor, cs: int, bit_depth: int,
                      pred: torch.Tensor) -> torch.Tensor:
    """CCLM predictions of N cs×cs chroma leaves (x0, y0, zi) of one wave
    into pred [N, cs, cs] int32, in place, for the leaves whose variant
    (1 LM, 2 LM_L, 3 LM_T) is not 0: gather_model_points with the
    decoder's availability `order_map < zi`, derive_model, the linear
    predictor on ds.  Replaces the per-leaf predict_cclm of
    vvc/dec/wavefront.py:100-104.  CUDA tensor → csrc/cclm.cu
    `wave_cclm`; CPU tensor or `ops.plain()` → the twin."""
    if ops.use_kernel(ds):
        return _cclm_wave_cuda(ds, chroma, order_map, xs, ys, zis, variants,
                               cs, bit_depth, pred)
    return predict_cclm_wave_plain(ds, chroma, order_map, xs, ys, zis,
                                   variants, cs, bit_depth, pred)

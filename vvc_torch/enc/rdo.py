"""Batched intra RDO: enumerate–mask–reduce partition/mode search.

Port of vvc/enc/rdo.py (reference: EncCu.cpp → xCompressCU; IntraSearch.cpp
→ estIntraPredLumaQT's SATD prescreen + RD shortlist):

  1. For every candidate shape — the squares 8..64, and with MTT the
     rectangles of the shape lattice and the TT middle-child planes —
     evaluate ALL blocks of the frame at that shape on the device:
     reference lines from the original plane (`build_ref_lines_device`,
     csrc/ref_lines.cu, its W×H entry for rectangles), 67-mode prediction
     (csrc/intra_pred.cu; `intra_pred_all_rect` with the wide-angle remap
     for rectangles) plus, lossy at square 8..32, the 9 MIP modes
     (csrc/mip.cu), and the SATD prescreen (csrc/satd.cu).  Lossless stops
     there: SATD + √λ·mode bits is the cost.  Lossy keeps a stable top-3
     shortlist and runs full RD on it — forward transform
     (csrc/transform.cu), quantise + level rate + dequantise
     (csrc/quant_rate.cu), inverse transform, SSE — with DCT2 (stage A),
     then the four other MTS pairs on the winner with both sides 8..32
     (stage B), then, at squares, the two LFNST kernels on the winner's
     DCT2 coefficients (stage C, csrc/lfnst.cu).  With ISP, both split
     directions of the winning mode are costed sub-TU by sub-TU
     (`eval_isp_dir`: `intra_pred_one` / `intra_pred_one_rect`, the
     4-point transforms).  With the chroma planes, each square block also
     decides its chroma mode on the device (DM / LM / LM_L / LM_T by SSE
     on the original samples: csrc/cclm.cu for the downsampled luma and
     the linear models, csrc/intra_pred.cu `intra_pred_one` for DM).  One
     packed int32 vector per frame comes back.
  2. The host DPs (`_dp_backtrack`, `_dp_backtrack_mtt`, copied
     unchanged) pick split/leaf per node.

The float32 costs are bit-equal to vvc's on XLA-CPU, because the host DP
compares them bit for bit: λ and √λ are float32 bit tables, the level rate
is XLA's own (vvc_torch.cabac.rates.level_bits), block sums follow XLA's
order for each shape (vvc_torch.kernels.quant.xla_block_sum, rate_order)
and `sse + λ·(rate + bits)` is rounded once, as the FMA XLA-CPU contracts
it to.

Deviation from vvc: the JAX program also evaluates the TT middle-child
planes (`_tt_descriptors`) for the QT-only candidate list, whose DP never
reads them; the port searches them only with MTT.  The square-shape part
of the packed vector is bit-equal to vvc's.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from vvc_torch import ops
from vvc_torch.kernels.cclm import (CCLM_SHIFT, derive_models_batch_dev,
                                    luma_ds_plane_dev)
from vvc_torch.kernels.intra import (predict_all_modes_batch_rect,
                                     predict_modes_batch,
                                     predict_modes_batch_rect)
from vvc_torch.kernels.lfnst import (fwd_lfnst_batch, inv_lfnst_batch,
                                     lfnst_allowed)
from vvc_torch.kernels.mip import (K_MIP_MODES, MIP_MODE_BASE, mip_allowed,
                                   mip_predict_all_batch)
from vvc_torch.kernels.quant import quant_rate, xla_block_sum
from vvc_torch.kernels.satd import satd_batch
from vvc_torch.kernels.transform import (MTS_TR, fwd_transform_batch,
                                         inv_transform_batch)
from vvc_torch.model.frame import Leaf
from vvc_torch.utils.trace import active as _trace
from vvc_torch.model.partition import (SPLIT_NONE, SPLIT_QT,
                                       SPLIT_BT_H, SPLIT_BT_V)

RD_SHORTLIST = 3  # full-RD candidates after SATD prescreen (EncModeCtrl analog)

# approximate mode signalling cost in bits (MPM statistics analog)
_MODE_BITS = np.full((67,), 7.0, dtype=np.float32)
_MODE_BITS[0] = 2.5   # planar (MPM[0])
_MODE_BITS[1] = 4.0   # DC
_MODE_BITS[18] = 5.0
_MODE_BITS[50] = 5.0

# approximate mts_idx signalling cost (truncated-unary ctx bins)
_MTS_BITS = (0.5, 2.0, 3.0, 4.0, 4.0)

# approximate MIP signalling cost: mip_flag + TB(K) mode bits
_MIP_BITS = 4.5

# approximate lfnst_idx signalling cost (truncated unary, cMax 2)
_LFNST_BITS = (0.0, 2.0, 3.0)

# float32 bits of λ = 0.57·2^((qp−12)/3) and √λ for qp 0..63, as the JAX
# reference computes them (XLA's exp2 differs from libm's in the last bit
# for many qp, and the packed costs are compared bit for bit by the DP).
LAMBDA_F32_BITS = (
    0x3d11eb85, 0x3d37d902, 0x3d67a231, 0x3d91eb85, 0x3db7d902, 0x3de7a231,
    0x3e11eb85, 0x3e37d902, 0x3e67a231, 0x3e91eb85, 0x3eb7d902, 0x3ee7a231,
    0x3f11eb85, 0x3f37d902, 0x3f67a231, 0x3f91eb85, 0x3fb7d902, 0x3fe7a231,
    0x4011eb85, 0x4037d902, 0x4067a231, 0x4091eb85, 0x40b7d902, 0x40e7a231,
    0x4111eb85, 0x4137d902, 0x4167a231, 0x4191eb85, 0x41b7d902, 0x41e7a231,
    0x4211eb85, 0x4237d902, 0x4267a231, 0x4291eb85, 0x42b7d902, 0x42e7a231,
    0x4311eb85, 0x4337d902, 0x4367a231, 0x4391eb85, 0x43b7d902, 0x43e7a231,
    0x4411eb85, 0x4437d902, 0x4467a231, 0x4491eb85, 0x44b7d902, 0x44e7a239,
    0x4511eb85, 0x4537d8fc, 0x4567a232, 0x4591eb8a, 0x45b7d902, 0x45e7a22a,
    0x4611eb85, 0x4637d907, 0x4667a232, 0x4691eb80, 0x46b7d902, 0x46e7a239,
    0x4711eb85, 0x4737d8fc, 0x4767a232, 0x4791eb8a)
SQRT_LAMBDA_F32_BITS = (
    0x3e414698, 0x3e58f1d9, 0x3e738320, 0x3e88aaa6, 0x3e996730, 0x3eac306b,
    0x3ec14698, 0x3ed8f1d9, 0x3ef38320, 0x3f08aaa6, 0x3f196730, 0x3f2c306b,
    0x3f414698, 0x3f58f1d9, 0x3f738320, 0x3f88aaa6, 0x3f996730, 0x3fac306b,
    0x3fc14698, 0x3fd8f1d9, 0x3ff38320, 0x4008aaa6, 0x40196730, 0x402c306b,
    0x40414698, 0x4058f1d9, 0x40738320, 0x4088aaa6, 0x40996730, 0x40ac306b,
    0x40c14698, 0x40d8f1d9, 0x40f38320, 0x4108aaa6, 0x41196730, 0x412c306b,
    0x41414698, 0x4158f1d9, 0x41738320, 0x4188aaa6, 0x41996730, 0x41ac306b,
    0x41c14698, 0x41d8f1d9, 0x41f38320, 0x4208aaa6, 0x42196730, 0x422c306e,
    0x42414698, 0x4258f1d5, 0x42738320, 0x4288aaa9, 0x42996730, 0x42ac3068,
    0x42c14698, 0x42d8f1dc, 0x42f38320, 0x4308aaa4, 0x43196730, 0x432c306e,
    0x43414698, 0x4358f1d5, 0x43738320, 0x4388aaa9)


def lambda_f32(qp: int) -> tuple[np.float32, np.float32]:
    """(λ, √λ) as float32 for the device search, from the bit tables."""
    bits = np.array([LAMBDA_F32_BITS[qp], SQRT_LAMBDA_F32_BITS[qp]],
                    dtype=np.uint32)
    lam, sqrt_lam = bits.view(np.float32)
    return lam, sqrt_lam


def rd_lambda(qp: int) -> float:
    """λ for intra RD (reference: EncSlice::setUpLambda, SURVEY.md §3.5)."""
    return 0.57 * (2.0 ** ((qp - 12) / 3.0))


def build_ref_lines_device_rect_plain(plane: torch.Tensor, xs: torch.Tensor,
                                      ys: torch.Tensor, w: int, h: int,
                                      bit_depth: int) -> torch.Tensor:
    """Plain PyTorch twin of vvc/enc/rdo.py:86 build_ref_lines_device_rect
    (and, at W = H, of :59 build_ref_lines_device): [N, 2H+2W+3] int32."""
    ph, pw = plane.shape
    mid = 1 << (bit_depth - 1)
    xs = xs.long()
    ys = ys.long()
    kh = torch.arange(2 * h, device=plane.device)
    kw = torch.arange(2 * w, device=plane.device)
    lx = (xs - 1).clamp(0, pw - 1)
    lyy = (ys[:, None] + kh[None, :]).clamp(0, ph - 1)
    left = plane[lyy, lx[:, None]]
    ty = (ys - 1).clamp(0, ph - 1)
    txx = (xs[:, None] + kw[None, :]).clamp(0, pw - 1)
    top = plane[ty[:, None], txx]
    corner = plane[ty, lx]
    left0 = left[:, :1]
    top = torch.where((ys > 0)[:, None], top,
                      torch.where((xs > 0)[:, None], left0,
                                  torch.full_like(top, mid)))
    corner = torch.where(ys > 0, corner,
                         torch.where(xs > 0, left0[:, 0],
                                     torch.full_like(corner, mid)))
    left = torch.where((xs > 0)[:, None], left,
                       torch.where((ys > 0)[:, None], top[:, :1],
                                   torch.full_like(left, mid)))
    return torch.cat([left.flip(1), corner[:, None], top, top[:, -1:],
                      top[:, -1:]], dim=1).to(torch.int32)


def build_ref_lines_device_plain(plane: torch.Tensor, xs: torch.Tensor,
                                 ys: torch.Tensor, size: int,
                                 bit_depth: int) -> torch.Tensor:
    """Plain PyTorch twin of vvc/enc/rdo.py:59 build_ref_lines_device."""
    return build_ref_lines_device_rect_plain(plane, xs, ys, size, size,
                                             bit_depth)


def _ref_lines_cuda(plane, xs, ys, w: int, h: int, bit_depth: int):
    name = "ref_lines" if w == h else "ref_lines_rect"
    ops.check_cuda_i32(name, plane, xs, ys)
    ph, pw = plane.shape
    n = xs.shape[0]
    if ys.shape != (n,):
        raise ValueError(f"{name}: xs and ys must be [N]")
    out = torch.empty((n, 2 * h + 2 * w + 3), dtype=torch.int32,
                      device=plane.device)
    lib = ops.lib(name)
    if w == h:
        fn = lib.ref_lines_launch
        args = (w,)
    else:
        fn = lib.ref_lines_rect_launch
        args = (w, h)
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int] * (2 + len(args))
                   + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    err = fn(plane.data_ptr(), ph, pw, xs.data_ptr(), ys.data_ptr(), n,
             *args, bit_depth, out.data_ptr(), ops.stream_ptr(plane))
    ops.launched(name, err)
    return out


def build_ref_lines_device(plane: torch.Tensor, xs: torch.Tensor,
                           ys: torch.Tensor, size: int,
                           bit_depth: int) -> torch.Tensor:
    """Device-side reference lines from the original plane for N blocks.

    Availability approximated by edge clamping (equivalent to spec
    substitution at frame borders).  plane [H,W] int32, xs/ys [N] int32 →
    [N, 4S+3] int32.  CUDA tensor → csrc/ref_lines.cu; CPU tensor or
    `ops.plain()` → build_ref_lines_device_plain."""
    if ops.use_kernel(plane):
        return _ref_lines_cuda(plane, xs, ys, size, size, bit_depth)
    return build_ref_lines_device_plain(plane, xs, ys, size, bit_depth)


def build_ref_lines_device_rect(plane: torch.Tensor, xs: torch.Tensor,
                                ys: torch.Tensor, w: int, h: int,
                                bit_depth: int) -> torch.Tensor:
    """Rect twin of build_ref_lines_device: [N, 2H+2W+3] int32 lines (left
    2H reversed, corner, top 2W, 2 pads) of W×H blocks at (xs, ys).  Port
    of vvc/enc/rdo.py:86.  CUDA tensor → csrc/ref_lines.cu (entry
    `ref_lines_rect`, W ≠ H); CPU tensor or `ops.plain()` →
    build_ref_lines_device_rect_plain."""
    if w == h:
        return build_ref_lines_device(plane, xs, ys, w, bit_depth)
    if ops.use_kernel(plane):
        return _ref_lines_cuda(plane, xs, ys, w, h, bit_depth)
    return build_ref_lines_device_rect_plain(plane, xs, ys, w, h, bit_depth)


def eval_blocks(orig: torch.Tensor, refs: torch.Tensor, size: int, qp: int,
                bit_depth: int = 8, try_mts: bool = False,
                lossless: bool = False, try_mip: bool = False,
                try_lfnst: bool = False, h: int | None = None,
                mid: bool = False, vmapped: bool = False,
                sharded: bool = False):
    """[N,H,W] originals + [N,2H+2W+3] refs → (best_cost [N] f32,
    best_mode [N] i32, best_mts [N] i32, best_lfnst [N] i32); W = size,
    H = h (default: square).

    SATD prescreen over the 67 modes (+ the 9 MIP modes 67..75 when
    try_mip) + √λ·mode bits.  Lossless (transquant bypass): that is the
    whole cost; argmin keeps the first minimum like jnp.argmin.  Lossy:
    full RD on the stable top-3 shortlist with DCT2 (stage A), then the
    four other MTS pairs on the winning mode when try_mts (stage B, strict
    `<`), then LFNST 1 and 2 on the winner's DCT2 coefficients when
    try_lfnst (stage C, strict `<`; a win resets the MTS choice to 0).
    h != size is a rect MTT shape (wide-angle predictor; MIP and LFNST are
    square-only and must be off, as in vvc).  mid, vmapped: the blocks are
    a TT mid plane's / the search runs as vvc's vmapped tile program,
    whose SSE sums XLA orders differently (sse_order).  sharded: the
    search runs as one of vvc's own programs (sharded_rdo_step's, or the
    shard_map of the sharded encode), where XLA sums the level rates of
    stages A and B of every 8-wide block (8×8 and the MTT shapes 8×16 and
    8×32) along the rows, as stage C's."""
    w = size
    h = w if h is None else h
    if w != h and (try_mip or try_lfnst):
        raise ValueError("eval_blocks: MIP and LFNST are square-only")
    lam, sqrt_lam = lambda_f32(qp)
    n = orig.shape[0]
    dev = orig.device
    preds = predict_all_modes_batch_rect(refs, w, h, bit_depth)  # [N,67,H,W]
    satd = satd_batch(preds, orig)                              # [N,67]
    mode_bits_np = _MODE_BITS
    mip = None
    if try_mip:
        mip = mip_predict_all_batch(refs, size, bit_depth)      # [N,9,S,S]
        satd = torch.cat([satd, satd_batch(mip, orig)], dim=1)  # [N,76]
        mode_bits_np = np.concatenate(
            [_MODE_BITS, np.full((K_MIP_MODES,), _MIP_BITS, np.float32)])
    # cost = satd + √λ·bits with ONE float32 rounding: the JAX program's
    # XLA fusion contracts the multiply-add into an FMA
    mode_bits = torch.from_numpy(mode_bits_np).to(dev)
    pre_cost = _fma_f32(sqrt_lam, mode_bits[None, :], satd)
    if lossless:
        best_cost, best_mode = _min_argmin(pre_cost)
        zeros = torch.zeros_like(best_mode)
        return best_cost, best_mode, zeros, zeros
    # lax.top_k(-pre_cost, 3) keeps the lower index on a tie: a stable
    # ascending sort does the same (torch.topk promises no tie order)
    short = torch.sort(pre_cost, dim=1, stable=True).indices[:, :RD_SHORTLIST]
    cand = _gather_modes(preds, mip, short)                     # [N,K,H,W]
    resi = (orig[:, None] - cand).reshape(-1, h, w)
    extra = mode_bits[short].reshape(-1) + np.float32(_MTS_BITS[0])
    cost_a = _rd_pass(resi, cand.reshape(-1, h, w), MTS_TR[0], qp,
                      lam, extra, bit_depth, "midA" if mid else "A",
                      vmapped, sharded).reshape(n, RD_SHORTLIST)
    best_cost, best_k = _min_argmin(cost_a)
    best_k = best_k.long()
    best_mode = short.gather(1, best_k[:, None])[:, 0].to(torch.int32)
    best_mts = torch.zeros_like(best_mode)
    ar = torch.arange(n, device=dev)
    bp = cand[ar, best_k]                                       # [N,H,W]
    br = orig - bp
    bbits = mode_bits[best_mode.long()]
    if try_mts:
        for mi in range(1, len(MTS_TR)):
            c_mi = _rd_pass(br, bp, MTS_TR[mi], qp, lam,
                            bbits + np.float32(_MTS_BITS[mi]), bit_depth,
                            "midB" if mid else "B", vmapped, sharded)
            better = c_mi < best_cost
            best_cost = torch.where(better, c_mi, best_cost)
            best_mts = torch.where(better, torch.full_like(best_mts, mi),
                                   best_mts)
    best_lfnst = torch.zeros_like(best_mode)
    if try_lfnst:
        th0, tv0 = MTS_TR[0]
        coeff0 = fwd_transform_batch(br, bit_depth, th0, tv0)
        for li in (1, 2):
            # XLA vectorises this stage's 8×8 rate sum across rows, as it
            # does the 8×8 SSE (read from vvc's program; 16..64 as stage A)
            rate, deq = quant_rate(fwd_lfnst_batch(coeff0, best_mode, li),
                                   qp, bit_depth, row_lanes=size == 8)
            rec_resi = inv_transform_batch(
                inv_lfnst_batch(deq, best_mode, li), bit_depth, th0, tv0)
            rec = (bp + rec_resi).clamp(0, (1 << bit_depth) - 1)
            sse = _sse_f32(rec - bp - br)
            # XLA folds the two constant bit costs into one before adding
            # them to rate + mode bits (read from vvc's optimised HLO)
            extra = np.float32(_MTS_BITS[0] + _LFNST_BITS[li])
            c_li = _fma_f32(lam, (rate + bbits) + extra, sse)
            better = c_li < best_cost
            best_cost = torch.where(better, c_li, best_cost)
            best_mts = torch.where(better, 0, best_mts)
            best_lfnst = torch.where(better, li, best_lfnst)
    return best_cost, best_mode, best_mts, best_lfnst


def _gather_modes(preds: torch.Tensor, mip, short: torch.Tensor):
    """Predictions of the shortlisted modes [N,K,H,W]: angular/DC/planar
    from preds [N,67,H,W], MIP (mode ≥ 67) from mip [N,9,S,S] — without
    concatenating the two mode stacks."""
    n, k = short.shape
    h, w = preds.shape[-2:]
    idx = short[:, :, None, None].expand(n, k, h, w)
    cand = torch.gather(preds, 1, idx.clamp(max=MIP_MODE_BASE - 1))
    if mip is not None:
        cand = torch.where(idx >= MIP_MODE_BASE,
                           torch.gather(mip, 1, (idx - MIP_MODE_BASE)
                                        .clamp(min=0)), cand)
    return cand


def _rd_pass(resi, pred, tr, qp: int, lam, extra_bits, bit_depth: int,
             site: str = "A", vmapped: bool = False,
             sharded: bool = False):
    """RD cost [M] f32 of coding residuals resi [M,H,W] over predictions
    pred with transform pair tr: fwd transform → quant + level rate +
    dequant → inverse → SSE, then sse + λ·(rate + extra_bits) rounded once
    (vvc/enc/rdo.py rd_pass).  site, vmapped: which of the program's SSE
    sums this is (sse_order); sharded: an 8-wide block's rate sum runs
    along the rows (eval_blocks)."""
    th, tv = tr
    coeff = fwd_transform_batch(resi, bit_depth, th, tv)
    rate, deq = quant_rate(coeff, qp, bit_depth,
                           row_lanes=sharded and resi.shape[2] == 8)
    rec_resi = inv_transform_batch(deq, bit_depth, th, tv)
    rec = (pred + rec_resi).clamp(0, (1 << bit_depth) - 1)
    sse = _sse_f32(rec - pred - resi,
                   **sse_order(*resi.shape[1:], site, vmapped))
    return _fma_f32(lam, rate + extra_bits, sse)


def sse_order(h: int, w: int, site: str = "A",
              vmapped: bool = False) -> dict:
    """The order of vvc's float32 SSE sum over an H×W luma block at one
    site of its search program (used only at or above 2^24, below which
    every order gives the exact integer).  site: "A" (stage A of
    eval_blocks), "B" (stage B), "midA"/"midB" (the same stages on a TT
    mid plane), "isp" (an ISP sub-TU); vmapped: vvc's vmapped tile
    program.  Read from the x86 object code XLA-CPU emits for the MTT
    search program (jax 0.9.0, AVX2; the backend turns each row's
    vectorised adds into one chain of FMAs, so the IR's association is not
    the one that runs):
      * row lanes at 8×8 (`_sse_f32`'s default) and where
        `_RECT_SSE_ROWS` lists the shape;
      * 32 wide in stage A (squares too): the row's parts added onto the
        running total in the order P0, P2, P3, P1;
      * 16 and 32 wide on a mid plane's stage A in the vmapped program:
        the tail order;
      * otherwise the default order (windows at a side of 64)."""
    if (h, w) in _RECT_SSE_ROWS[site]:
        return {"row_lanes": True}
    if site == "midA" and vmapped and w in (16, 32):
        return {"tail": True}
    if site in ("A", "midA") and w == 32 and h < 64:
        return {"part_order": (0, 2, 3, 1)}
    return {}           # _sse_f32's default: row lanes at 8×8


# The rect (H, W) whose SSE XLA-CPU vectorises along the rows (row
# lanes), per site of vvc's search program (the 8- and 4-wide blocks, and
# in the ISP stage also the 8×16 sub-TU and the 4-row sub-TUs of 8 and 16
# columns); every other rect shape is summed in the default order.
_RECT_SSE_ROWS = {
    "A": {(16, 8), (32, 8)},
    "B": {(16, 8), (32, 8)},
    "midA": {(16, 8)},
    "midB": {(16, 8)},
    "isp": {(8, 4), (16, 4), (32, 4), (16, 8), (32, 8), (8, 16), (4, 8),
            (4, 16)},
}


def _sse_f32(d: torch.Tensor, row_lanes: bool | None = None,
             **order) -> torch.Tensor:
    """Σ d² per block as vvc's float32 `jnp.sum` gives it.  The integer sum
    is exact; while it stays below 2^24 every float32 partial sum is an
    exact integer whatever the order, so the cast is the answer.  Larger
    sums (rare: a 32×32 block needs a mean squared error above 16384) take
    XLA's summation order: `xla_block_sum`'s, with its row lanes where
    `row_lanes` says so (by default at 8×8, the luma SSE's order), or its
    `tail` order where `order` says so."""
    dl = d.to(torch.int64)
    exact = (dl * dl).sum(dim=(1, 2))
    out = exact.to(torch.float32)
    big = exact >= (1 << 24)
    if bool(big.any()):
        dd = d[big].to(torch.float32)
        if row_lanes is None:
            row_lanes = d.shape[-1] == 8 and d.shape[-2] == 8
        out[big] = xla_block_sum(dd * dd, row_lanes=row_lanes, **order)
    return out


def _fma_f32(a, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a·b + c rounded once, as the FMA XLA-CPU contracts it to.
    The float64 product of two float32 values is exact; the sum is made
    exact by TwoSum and rounded to odd in float64, after which the cast to
    float32 rounds correctly (53 ≥ 24 + 2 bits)."""
    p = float(a) * b.to(torch.float64)
    c64 = c.to(torch.float64)
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def _min_argmin(cost: torch.Tensor):
    """Per-row (min, argmin as int32); a tie goes to the lowest index, as
    jnp.argmin does (torch.argmin returns the first minimal index)."""
    best = torch.argmin(cost, dim=1)
    return cost.gather(1, best[:, None])[:, 0], best.to(torch.int32)


def eval_chroma_modes(cb: torch.Tensor, cr: torch.Tensor, ds: torch.Tensor,
                      xs: torch.Tensor, ys: torch.Tensor, size: int,
                      best_mode: torch.Tensor, bit_depth: int,
                      vmapped: bool = False,
                      sharded: int = 0) -> torch.Tensor:
    """Device 4-way chroma decision (DM / LM / LM_L / LM_T) for N blocks of
    luma size `size` at (xs, ys): SSE on the original chroma samples, cb
    and cr costs added, argmin with the first index winning a tie.  Port of
    vvc/enc/rdo.py:282 → [N] int32.  xs and ys are the grid of the whole
    frame or tile at this size, as vvc's callers give them.

    Float roundings as vvc's: each plane's float32 sum, then
    float32(cost_cb) + cost_cr, rounded once more.  A plane sum below 2^24
    is exact in any order (a 4×4 block of 10-bit samples never reaches
    it).  Above, the order is the one XLA-CPU gives each of the 8 sums in
    vvc's fused program (read from its optimised LLVM IR).  Each sum is
    fused into its cost update (or, where two variants compute the same
    sum, kept as a reduction of its own), and LLVM vectorises it one of
    two ways: along the columns (`xla_block_sum`'s default order) or,
    where it unrolls the column loop, along the rows (row lanes).  The DM
    sum is vectorised along the columns.  An LM sum is vectorised along
    the rows at 8×8 and 16×16, and at 32×32 only where its model is the
    no-neighbour constant (0, 2^(bd-1)) for every block of the grid: when
    no block has a row above (LM_T), or a column to its left (LM_L), or
    neither (all three).

    vmapped: the orders of vvc's vmapped tile program
    (`eval_all_sizes_frames`, read from its LLVM IR at F = 2 and 3 on 64×64
    and 64×128 tiles), whose gathers put the tile index minor.  There the
    DM sum at 16×16 and 32×32 takes `xla_block_sum`'s `tail` order (all
    columns but the last 8 lane-wise, then those 8 one by one); so does an
    LM sum at 32×32 whose model is not the constant; the other LM sums run
    along the rows, as in the single-frame program.

    sharded: the chunk size k of vvc's sharded program (0: not sharded).
    For k ≥ 2 its orders are the vmapped program's (pass vmapped=True).
    For k = 1 (a rank's vmap over one cell) they are the single-frame
    program's, except that the DM sum at 16×16 and 32×32 takes the `tail`
    order where the tile holds more than one block of the size (read at
    k = 1 on 64×64 tiles, from the optimised LLVM IR and from decisions,
    and on 64×128 tiles from decisions; ROADMAP §3)."""
    cs = size >> 1
    cxs, cys = xs >> 1, ys >> 1
    no_top = not bool((ys > 0).any())
    no_left = not bool((xs > 0).any())
    const = {1: no_top and no_left, 2: no_left, 3: no_top}
    lm_rows = {v: cs <= 16 or const[v] for v in const}
    dm_tail = vmapped or (sharded == 1 and xs.numel() > 1)
    dm_order = {"tail": True} if dm_tail and cs >= 16 else {}
    lm_order = {v: {"tail": True} if vmapped and not lm_rows[v] else {}
                for v in const}
    dm = torch.where(best_mode >= 67, 0, best_mode).to(torch.int32)
    o = torch.arange(cs, device=xs.device)
    iy = (cys.long()[:, None, None] + o[None, :, None])
    ix = (cxs.long()[:, None, None] + o[None, None, :])
    ds_blk = ds[iy, ix]
    maxv = (1 << bit_depth) - 1
    cost = None
    for plane in (cb, cr):
        refs = build_ref_lines_device(plane, cxs, cys, cs, bit_depth)
        pdm = predict_modes_batch(refs, dm, cs, bit_depth)
        obs = plane[iy, ix]
        sums = [_sse_f32(obs - pdm, row_lanes=False, **dm_order)]
        for v in (1, 2, 3):
            alpha, beta = derive_models_batch_dev(ds, plane, cxs, cys, cs,
                                                  bit_depth, v)
            plm = ((alpha[:, None, None] * ds_blk >> CCLM_SHIFT)
                   + beta[:, None, None]).clamp(0, maxv)
            sums.append(_sse_f32(obs - plm, row_lanes=lm_rows[v],
                                 **lm_order[v]))
        plane_cost = torch.stack(sums, dim=1)                   # [N,4] f32
        cost = plane_cost if cost is None else cost + plane_cost
    return torch.argmin(cost, dim=1).to(torch.int32)


# float32 bits of E = 2^((qp−12)/3) for qp 0..63 as XLA computes it (λ is
# float32(0.57·E)): the ISP stage's λ·2.5 is folded by XLA into
# E·float32(1.425), one rounding from E, not from λ
EXP2_F32_BITS = (
    0x3d800000, 0x3da14518, 0x3dcb2ff5, 0x3e000000, 0x3e214518, 0x3e4b2ff5,
    0x3e800000, 0x3ea14518, 0x3ecb2ff5, 0x3f000000, 0x3f214518, 0x3f4b2ff5,
    0x3f800000, 0x3fa14518, 0x3fcb2ff5, 0x40000000, 0x40214518, 0x404b2ff5,
    0x40800000, 0x40a14518, 0x40cb2ff5, 0x41000000, 0x41214518, 0x414b2ff5,
    0x41800000, 0x41a14518, 0x41cb2ff5, 0x42000000, 0x42214518, 0x424b2ff5,
    0x42800000, 0x42a14518, 0x42cb2ff5, 0x43000000, 0x43214518, 0x434b2ff5,
    0x43800000, 0x43a14518, 0x43cb2ff5, 0x44000000, 0x44214518, 0x444b2ff5,
    0x44800000, 0x44a14518, 0x44cb2ff5, 0x45000000, 0x45214518, 0x454b2ffc,
    0x45800000, 0x45a14513, 0x45cb2ff6, 0x46000004, 0x46214518, 0x464b2fef,
    0x46800000, 0x46a1451d, 0x46cb2ff6, 0x46fffff8, 0x47214518, 0x474b2ffc,
    0x47800000, 0x47a14513, 0x47cb2ff6, 0x48000004)

# approximate ISP signalling cost: isp flag + direction + per-sub cbf bins
_ISP_BITS = 2.5
_ISP_CBF_BITS = 0.8


def _isp_bits_f32(qp: int) -> np.float32:
    """λ·_ISP_BITS as vvc's program computes it: E·float32(0.57·2.5)."""
    e = np.array([EXP2_F32_BITS[qp]], dtype=np.uint32).view(np.float32)[0]
    return np.float32(e * (np.float32(0.57) * np.float32(_ISP_BITS)))


def eval_isp_dir(plane: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor,
                 w: int, h: int, modes: torch.Tensor, qp: int,
                 bit_depth: int, direction: int,
                 sharded: bool = False) -> torch.Tensor:
    """RD cost [N] f32 of coding each W×H block at (xs, ys) with ISP in
    `direction`, using its (already decided) intra mode.  Port of
    vvc/enc/rdo.py:126: every sub-TU is predicted from *original*
    neighbours at its own position (square sub-TUs: ref_lines and
    intra_pred_one; rect: ref_lines_rect and intra_pred_one_rect), coded
    with its implicit DST7/DCT2 pair (transform, quant_rate, inverse), and
    its cost accumulated as XLA's program does it: t = fma(λ, rate + 0.8,
    t + sse) sub-TU by sub-TU (the first: fma(λ, rate + 0.8, sse)), then
    t + E·1.425 (λ·2.5 folded, see _isp_bits_f32).  sharded: the search
    runs as vvc's sharded program, where an 8-wide sub-TU's rate sums along
    the rows (read from its search vectors, ROADMAP §3)."""
    from vvc_torch.kernels.isp import isp_partitions, isp_tr_types
    lam, _ = lambda_f32(qp)
    cbf = np.float32(_ISP_CBF_BITS)
    cost = None
    for (xo, yo, sw, sh) in isp_partitions(w, h, direction):
        sxs, sys_ = xs + xo, ys + yo
        if sw == sh:
            refs = build_ref_lines_device(plane, sxs, sys_, sw, bit_depth)
            pred = predict_modes_batch(refs, modes, sw, bit_depth)
        else:
            refs = build_ref_lines_device_rect(plane, sxs, sys_, sw, sh,
                                               bit_depth)
            pred = predict_modes_batch_rect(refs, modes, sw, sh, bit_depth)
        oy = sys_.long()[:, None, None] + torch.arange(
            sh, device=plane.device)[None, :, None]
        ox = sxs.long()[:, None, None] + torch.arange(
            sw, device=plane.device)[None, None, :]
        resi = plane[oy, ox] - pred
        th, tv = isp_tr_types(sw, sh)
        coeff = fwd_transform_batch(resi, bit_depth, th, tv)
        rate, deq = quant_rate(coeff, qp, bit_depth,
                               row_lanes=sharded and sw == 8)
        rec_resi = inv_transform_batch(deq, bit_depth, th, tv)
        sse = _sse_f32(rec_resi - resi, **sse_order(sh, sw, "isp"))
        acc = sse if cost is None else cost + sse
        cost = _fma_f32(lam, rate + cbf, acc)
    return cost + _isp_bits_f32(qp)


def eval_size_plane(plane: torch.Tensor, size: int, qp: int, bit_depth: int,
                    ny: int, nx: int, mts_enabled: bool = True,
                    lossless: bool = False, lfnst_enabled: bool = True,
                    chroma=None, h: int | None = None,
                    isp_enabled: bool = False, vmapped: bool = False,
                    sharded: int = 0):
    """Whole-frame single-shape evaluation of W×H blocks (W = size, H = h,
    default square): plane [H,W] int32 → (cost [ny,nx] f32, mode, mts,
    lfnst, chroma_mode, isp [ny,nx] i32).  Port of vvc/enc/rdo.py:314.
    chroma: optional (cb, cr, ds) planes for the device chroma decision
    (square shapes only, as in vvc); vmapped: take the chroma sum orders of
    vvc's vmapped program; sharded: the chunk size k of vvc's sharded
    program (eval_blocks, eval_chroma_modes), 0 when not sharded.  Rect
    shapes run with MIP, LFNST and the chroma decision off; ISP
    (isp_enabled, lossy, both sides 8..32) tries both directions on the
    winning non-MIP mode and clears MTS and LFNST where it wins."""
    s = size
    bh = s if h is None else h
    dev = plane.device
    blocks = (plane[:ny * bh, :nx * s]
              .reshape(ny, bh, nx, s).permute(0, 2, 1, 3).reshape(-1, bh, s)
              .contiguous())
    ys = (torch.arange(ny, dtype=torch.int32, device=dev) * bh
          ).repeat_interleave(nx)
    xs = (torch.arange(nx, dtype=torch.int32, device=dev) * s).repeat(ny)
    square = bh == s
    refs = build_ref_lines_device_rect(plane, xs, ys, s, bh, bit_depth)
    try_mts = ((not lossless) and mts_enabled
               and 8 <= s <= 32 and 8 <= bh <= 32)      # spec limit 32
    try_mip = (not lossless) and square and mip_allowed(s)
    try_lfnst = (not lossless) and square and lfnst_enabled and \
        lfnst_allowed(s)
    cost, mode, mts, lfnst = eval_blocks(blocks, refs, s, qp, bit_depth,
                                         try_mts, lossless, try_mip,
                                         try_lfnst, h=bh, vmapped=vmapped,
                                         sharded=sharded > 0)
    isp = torch.zeros_like(mode)
    if isp_enabled and not lossless and 8 <= s <= 32 and 8 <= bh <= 32:
        lam, _ = lambda_f32(qp)
        mode_ok = mode < 67                       # no ISP with MIP
        m = torch.where(mode_ok, mode, 0)
        mbits = torch.from_numpy(_MODE_BITS).to(dev)[m.long()]
        lam_bits = lam * mbits          # λ·bits, read twice: not contracted
        for d in (1, 2):
            c_isp = eval_isp_dir(plane, xs, ys, s, bh, m, qp, bit_depth,
                                 d, sharded > 0) + lam_bits
            better = mode_ok & (c_isp < cost)
            cost = torch.where(better, c_isp, cost)
            isp = torch.where(better, torch.full_like(isp, d), isp)
        mts = torch.where(isp > 0, 0, mts)
        lfnst = torch.where(isp > 0, 0, lfnst)
    cmode = torch.zeros_like(mode)
    if chroma is not None and square:
        cb, cr, ds = chroma
        cmode = eval_chroma_modes(cb, cr, ds, xs, ys, s, mode, bit_depth,
                                  vmapped, sharded)
    return (cost.reshape(ny, nx), mode.reshape(ny, nx), mts.reshape(ny, nx),
            lfnst.reshape(ny, nx), cmode.reshape(ny, nx),
            isp.reshape(ny, nx))


def eval_mid_plane(plane: torch.Tensor, desc, qp: int, bit_depth: int,
                   lossless: bool, lfnst_enabled: bool,
                   vmapped: bool = False, sharded: bool = False):
    """Leaf-cost plane for TT middle children.  Port of vvc/enc/rdo.py:398:
    desc ('TH', w) → (w, 16) blocks at (x = k·w, y = 8 + 32·r); ('TV', h)
    → (16, h) blocks at (x = 8 + 32·k, y = r·h).  Returns the 6-tuple of
    eval_size_plane (chroma decision and ISP off: TT mid leaves code
    chroma as DM).  vmapped: take the SSE orders of vvc's vmapped
    program; sharded: the rate orders of its sharded program
    (eval_blocks)."""
    ph, pw = plane.shape
    kind, s = desc
    dev = plane.device
    ar = lambda k: torch.arange(k, dtype=torch.int32, device=dev)
    if kind == "TH":
        bw, bh = s, 16
        ny, nx = ph // 32, pw // bw
        ys = (ar(ny) * 32 + 8).repeat_interleave(nx)
        xs = (ar(nx) * bw).repeat(ny)
    else:
        bw, bh = 16, s
        ny, nx = ph // s, pw // 32
        ys = (ar(ny) * s).repeat_interleave(nx)
        xs = (ar(nx) * 32 + 8).repeat(ny)
    oy = ys.long()[:, None, None] + ar(bh).long()[None, :, None]
    ox = xs.long()[:, None, None] + ar(bw).long()[None, None, :]
    blocks = plane[oy, ox].contiguous()
    square = bw == bh
    refs = build_ref_lines_device_rect(plane, xs, ys, bw, bh, bit_depth)
    try_mts = (not lossless) and 8 <= bw <= 32 and 8 <= bh <= 32
    try_mip = (not lossless) and square and mip_allowed(bw)
    try_lfnst = ((not lossless) and square and lfnst_enabled
                 and lfnst_allowed(bw))
    cost, mode, mts, lfnst = eval_blocks(blocks, refs, bw, qp, bit_depth,
                                         try_mts, lossless, try_mip,
                                         try_lfnst, h=bh, mid=True,
                                         vmapped=vmapped, sharded=sharded)
    z = torch.zeros_like(mode)
    return (cost.reshape(ny, nx), mode.reshape(ny, nx), mts.reshape(ny, nx),
            lfnst.reshape(ny, nx), z.reshape(ny, nx), z.reshape(ny, nx))


def _eval_all_sizes_impl(plane, sizes, qp, bit_depth, w, h, lossless=False,
                         lfnst=True, cb=None, cr=None, isp=False,
                         vmapped=False, sharded=0):
    # the downsampled luma of this frame or tile (a tile's own plane, so
    # its left column clamps at the tile edge, as vvc's vmap over tiles)
    chroma = None if cb is None else (cb, cr, luma_ds_plane_dev(plane))
    out = {}
    for (bw, bh) in _as_shapes(sizes):
        ny, nx = h // bh, w // bw
        if ny and nx:
            out[(bw, bh)] = eval_size_plane(plane, bw, qp, bit_depth, ny, nx,
                                            lossless=lossless,
                                            lfnst_enabled=lfnst,
                                            chroma=chroma, h=bh,
                                            isp_enabled=isp, vmapped=vmapped,
                                            sharded=sharded)
    for desc in _tt_descriptors(sizes):
        kind, s = desc
        ny = (h // 32, h // s)[kind == "TV"]
        nx = (w // s, w // 32)[kind == "TV"]
        if ny and nx:
            out[desc] = eval_mid_plane(plane, desc, qp, bit_depth, lossless,
                                       lfnst, vmapped, sharded > 0)
    return out


def _pack_results(out, sizes):
    """Flatten the per-shape result dict into ONE int32 vector (cost planes
    bitcast) so that one device→host transfer carries the whole search."""
    parts = []
    for sh in _as_shapes(sizes) + _tt_descriptors(sizes):
        if sh not in out:
            continue
        c, m, t, l, cm, isp = out[sh]
        parts += [c.contiguous().view(torch.int32).reshape(-1),
                  m.reshape(-1), t.reshape(-1), l.reshape(-1),
                  cm.reshape(-1), isp.reshape(-1)]
    return torch.cat(parts)


def eval_all_sizes(planes_vec: torch.Tensor, sizes: tuple, qp, bit_depth: int,
                   w: int, h: int, lossless: bool = False,
                   lfnst: bool = True, with_chroma: bool = False,
                   isp: bool = False) -> torch.Tensor:
    """All candidate shapes of one frame (squares, and with the MTT lattice
    its rectangles and TT mid planes) → ONE packed int32 vector on the
    planes' device.  planes_vec: pack_planes(y[, cb, cr]) as a tensor.
    Unpack with unpack_results."""
    y, cb, cr = _split_planes(planes_vec, w, h, with_chroma)
    return _pack_results(_eval_all_sizes_impl(y, sizes, int(qp), bit_depth,
                                              w, h, lossless, lfnst, cb, cr,
                                              isp), sizes)


def eval_all_sizes_frames(planes_vec: torch.Tensor, sizes: tuple, qp,
                          bit_depth: int, w: int, h: int, f: int,
                          lossless: bool = False, lfnst: bool = True,
                          with_chroma: bool = False,
                          isp: bool = False, sharded: bool = False
                          ) -> torch.Tensor:
    """[F] frames (or tile columns) → [F, per-frame packed length] int32.
    The JAX program's vmap over frames is a frame loop here; with F > 1 its
    chroma sums take the vmapped program's orders (eval_chroma_modes).
    sharded: the F planes are one rank's chunk of vvc's sharded program
    (vvc_torch.shard.encode), whose orders depend on F (eval_blocks,
    eval_chroma_modes)."""
    y, cb, cr = _split_planes(planes_vec, w, h, with_chroma, f)
    return torch.stack([
        _pack_results(_eval_all_sizes_impl(
            y[i], sizes, int(qp), bit_depth, w, h, lossless, lfnst,
            None if cb is None else cb[i], None if cr is None else cr[i],
            isp, vmapped=f > 1, sharded=f if sharded else 0), sizes)
        for i in range(f)])


def _to_device(vec: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(vec).to(ops.resolve_device(device))


def rdo_partition(y_plane: np.ndarray, qp: int, bit_depth: int = 8,
                  ctu_size: int = 64, min_cu: int = 8, lossless: bool = False,
                  lfnst: bool = True, chroma_planes=None, mtt: bool = False,
                  isp: bool = False, device=None):
    """Full-frame partition + mode decision → (split_map, leaf_map,
    leaves_zorder) for the syntax writer and the reconstruction pass.
    device: None = CUDA (raises without it); "cpu" runs the plain path."""
    return rdo_partition_finish(rdo_partition_dispatch(
        y_plane, qp, bit_depth, ctu_size, min_cu, lossless, lfnst,
        chroma_planes, mtt, isp, device))


def rdo_partition_dispatch(y_plane, qp: int, bit_depth: int = 8,
                           ctu_size: int = 64, min_cu: int = 8,
                           lossless: bool = False, lfnst: bool = True,
                           chroma_planes=None, mtt: bool = False,
                           isp: bool = False, device=None):
    """Async half of rdo_partition: queues the device search and returns
    the packed result tensor at once (CUDA launches are asynchronous), so
    the host pipeline overlaps with device compute.  Finish with
    rdo_partition_finish."""
    h, w = y_plane.shape
    assert w % min_cu == 0 and h % min_cu == 0, "pad input to min-CU multiple"
    shapes = _candidate_shapes(ctu_size, min_cu, mtt)
    with_chroma = chroma_planes is not None
    vec_dev = _to_device(pack_planes(y_plane, *(chroma_planes or (None, None))),
                         device)
    packed = eval_all_sizes(vec_dev, shapes, qp, bit_depth, w, h, lossless,
                            lfnst, with_chroma, isp)
    return (packed, w, h, qp, shapes, ctu_size, min_cu, mtt)


def rdo_partition_finish(handle):
    """Blocking half: transfer + DP backtrack."""
    packed, w, h, qp, shapes, ctu_size, min_cu, mtt = handle
    results = unpack_results(packed.cpu().numpy(), shapes, w, h)
    return _dp_backtrack(results, w, h, qp, shapes, ctu_size, min_cu, mtt)


def rdo_partition_frames(y_planes, qp: int, bit_depth: int = 8,
                         ctu_size: int = 64, min_cu: int = 8,
                         lossless: bool = False, lfnst: bool = True,
                         chroma_planes=None, mtt: bool = False,
                         isp: bool = False, device=None):
    """Batched variant: list of [H,W] planes → list of per-frame
    (split_map, leaf_map, leaves).  One upload and one transfer back."""
    h, w = y_planes[0].shape
    assert w % min_cu == 0 and h % min_cu == 0, "pad input to min-CU multiple"
    shapes = _candidate_shapes(ctu_size, min_cu, mtt)
    nf = len(y_planes)
    with_chroma = chroma_planes is not None
    vec = pack_planes(np.stack(y_planes),
                      *((np.stack(chroma_planes[0]),
                         np.stack(chroma_planes[1])) if with_chroma
                        else (None, None)))
    pk = eval_all_sizes_frames(_to_device(vec, device), shapes, qp,
                               bit_depth, w, h, nf, lossless, lfnst,
                               with_chroma, isp).cpu().numpy()
    return [_dp_backtrack(unpack_results(pk[f], shapes, w, h), w, h, qp,
                          shapes, ctu_size, min_cu, mtt)
            for f in range(nf)]


def rdo_partition_tiled(y_plane: np.ndarray, tiles, qp: int,
                        bit_depth: int = 8, ctu_size: int = 64,
                        min_cu: int = 8, lossless: bool = False,
                        lfnst: bool = True, chroma_planes=None,
                        mtt: bool = False, tile_results=None,
                        isp: bool = False, device=None):
    """Per-tile RDO: each tile column is searched on its own sub-plane
    (prediction references clamp at the tile edge, matching the tile
    reconstruction's availability).

    tiles: [(tx0, tx1)] from tile_columns.  tile_results: optional
    precomputed per-tile unpacked result dicts.  Returns frame-coordinate
    (split_map, leaf_map, leaves)."""
    h, w = y_plane.shape
    shapes = _candidate_shapes(ctu_size, min_cu, mtt)
    widths = [tx1 - tx0 for tx0, tx1 in tiles]
    with_chroma = chroma_planes is not None

    def chroma_of(tx0, tx1):
        if not with_chroma:
            return (None, None)
        return tuple(c[:, tx0 >> 1:tx1 >> 1] for c in chroma_planes)

    if tile_results is None:
        if len(set(widths)) == 1:
            wt = widths[0]
            ys = np.stack([y_plane[:, tx0:tx1] for tx0, tx1 in tiles])
            cbs = crs = None
            if with_chroma:
                cbs, crs = (np.stack(c) for c in zip(
                    *(chroma_of(tx0, tx1) for tx0, tx1 in tiles)))
            pk = eval_all_sizes_frames(
                _to_device(pack_planes(ys, cbs, crs), device), shapes, qp,
                bit_depth, wt, h, len(tiles), lossless, lfnst, with_chroma,
                isp).cpu().numpy()
            tile_results = [unpack_results(pk[i], shapes, wt, h)
                            for i in range(len(tiles))]
        else:
            tile_results = [
                unpack_results(eval_all_sizes(
                    _to_device(pack_planes(y_plane[:, tx0:tx1],
                                           *chroma_of(tx0, tx1)), device),
                    shapes, qp, bit_depth, tx1 - tx0, h, lossless, lfnst,
                    with_chroma, isp).cpu().numpy(), shapes, tx1 - tx0, h)
                for tx0, tx1 in tiles]
    split_map, leaf_map, leaves = {}, {}, []
    for (tx0, tx1), res in zip(tiles, tile_results):
        sm, lm, lv = _offset_rdo_result(
            _dp_backtrack(res, tx1 - tx0, h, qp, shapes, ctu_size, min_cu,
                          mtt), tx0)
        split_map.update(sm)
        leaf_map.update(lm)
        leaves.extend(lv)
    return split_map, leaf_map, leaves


# ---------------------------------------------------------------------------
# Host half — copied unchanged from vvc/enc/rdo.py (pack layout, DPs)
# ---------------------------------------------------------------------------


# Split-signalling rates from the measured per-context table
# (vvc_torch/cabac/rates.py SYNTAX_BITS, tools/measure_syntax_rates.py — the
# estFracBits analog; replaces the r2 hand-waved flat constants).
from vvc_torch.cabac.rates import SYNTAX_BITS as _SB

# test hook: disable TT candidates in the DP (decode support unaffected)
# for TT-on-vs-off A/B quality checks
TT_IN_SEARCH = True

# conservative margin (bits) on TT candidates: the DP's luma-only cost
# cannot see that TT mid leaves forfeit the 4-way chroma decision (rect
# CCLM not yet supported), ISP, and further splitting.  MEASURED by
# tools/calibrate_tt_margin.py (TT-on-vs-off BD-rate sweep on
# TT-friendly + neutral content); last run: margin 0/2 -> +0.06%
# overuse on tt-friendly, 4 -> -0.03% / -1.56% — re-run the tool after
# any quality-touching change (the r3 regression was a stale margin
# after a deblocking tc bug shifted recon quality).
TT_MARGIN_BITS = 4.0

SPLIT_LEAF_BITS = _SB["SPLIT_CU_FLAG"][0]  # leaf codes split_cu_flag = 0
SPLIT_BITS = _SB["SPLIT_CU_FLAG"][1]       # any split codes flag = 1
QT_FLAG_BITS = _SB["SPLIT_QT_FLAG"][1]     # QT chosen while MTT competes
MTT_FLAG_BITS = _SB["SPLIT_QT_FLAG"][0]    # MTT chosen while QT competes
MTT_DIR_BITS = (_SB["MTT_SPLIT_VERT"][0] + _SB["MTT_SPLIT_VERT"][1]) / 2
BT_FLAG_BITS = _SB["MTT_SPLIT_BINARY"][1]  # binary flag = 1 (BT)
TT_FLAG_BITS = _SB["MTT_SPLIT_BINARY"][0]  # binary flag = 0 (TT)


def _as_shapes(sizes):
    """Normalize a candidate list: ints (squares) or (w, h) pairs."""
    return tuple((s, s) if isinstance(s, int) else tuple(s) for s in sizes)


def _tt_descriptors(sizes):
    """TT middle-child cost planes needed beyond the aligned shape grids.

    TT outer children land on the aligned (w, h/4) grids; only the middle
    child (w, h/2) sits at the +h/4 half-offset, so each TT-capable parent
    shape adds ONE offset plane: ('TH', w) = (w,16) blocks at y ≡ 8 mod 32
    (stride 32), ('TV', h) mirrored.  Derived deterministically from the
    shape list so pack/unpack order always agrees."""
    from vvc_torch.model.partition import allowed_splits
    shapes = _as_shapes(sizes)
    if all(bw == bh for bw, bh in shapes):
        # QT-only candidate list: _dp_backtrack never reads TT mid planes
        return ()
    out = []
    for (bw, bh) in shapes:
        if allowed_splits(bw, bh, False, True)[3]:       # can_tt_h
            out.append(("TH", bw))
        if allowed_splits(bw, bh, False, True)[4]:       # can_tt_v
            out.append(("TV", bh))
    return tuple(out)


def unpack_results(vec: np.ndarray, sizes, w: int, h: int):
    """Host-side inverse of _pack_results → {(bw, bh): (cost, mode, mts,
    lfnst, chroma_mode, isp)} numpy arrays."""
    out = {}
    off = 0
    keys = []
    for (bw, bh) in _as_shapes(sizes):
        keys.append(((bw, bh), h // bh, w // bw))
    for desc in _tt_descriptors(sizes):
        kind, s = desc
        keys.append((desc, (h // 32, h // s)[kind == "TV"],
                     (w // s, w // 32)[kind == "TV"]))
    for key, ny, nx in keys:
        if not (ny and nx):
            continue
        n = ny * nx
        c = vec[off:off + n].view(np.float32).reshape(ny, nx); off += n
        m = vec[off:off + n].reshape(ny, nx); off += n
        t = vec[off:off + n].reshape(ny, nx); off += n
        l = vec[off:off + n].reshape(ny, nx); off += n
        cm = vec[off:off + n].reshape(ny, nx); off += n
        isp = vec[off:off + n].reshape(ny, nx); off += n
        out[key] = (c, m, t, l, cm, isp)
    return out


def _split_planes(vec, w, h, with_chroma, f=None):
    """Unpack the single host→device input vector back into planes."""
    shape_y = (h, w) if f is None else (f, h, w)
    ny = int(np.prod(shape_y))
    y = vec[:ny].reshape(shape_y)
    if not with_chroma:
        return y, None, None
    shape_c = (h // 2, w // 2) if f is None else (f, h // 2, w // 2)
    nc = int(np.prod(shape_c))
    cb = vec[ny:ny + nc].reshape(shape_c)
    cr = vec[ny + nc:ny + 2 * nc].reshape(shape_c)
    return y, cb, cr


def pack_planes(y, cb=None, cr=None):
    """Host-side input packing (one device_put instead of three)."""
    parts = [np.asarray(y, dtype=np.int32).ravel()]
    if cb is not None:
        parts += [np.asarray(cb, dtype=np.int32).ravel(),
                  np.asarray(cr, dtype=np.int32).ravel()]
    return np.concatenate(parts)


def _candidate_sizes(ctu_size: int, min_cu: int):
    """Leaf/TB candidate sizes: capped at 64 (MaxCUSize/MaxTbSize 64 —
    CTU 128 nodes split implicitly before coding; reference: CommonDef
    MAX_CU_SIZE vs MAX_TB_SIZEY)."""
    sizes = []
    s = min_cu
    while s <= min(ctu_size, 64):
        sizes.append(s)
        s <<= 1
    return sizes


def _candidate_shapes(ctu_size: int, min_cu: int, mtt: bool):
    if mtt:
        from vvc_torch.model.partition import shape_lattice
        return shape_lattice(min(ctu_size, 64), True)
    return tuple((s, s) for s in _candidate_sizes(ctu_size, min_cu))


def _offset_rdo_result(result, dx: int):
    """Shift a per-tile (split_map, leaf_map, leaves) to frame coords."""
    if dx == 0:
        return result
    sm, lm, leaves = result
    for leaf in leaves:
        leaf.x0 += dx
    return ({(x + dx, y, bw, bh): v for (x, y, bw, bh), v in sm.items()},
            {(x + dx, y, bw, bh): v for (x, y, bw, bh), v in lm.items()},
            leaves)


def _dp_backtrack(results, w, h, qp, sizes, ctu_size, min_cu, mtt=False):
    if mtt:
        return _dp_backtrack_mtt(results, w, h, qp, sizes, ctu_size, min_cu)
    lam = rd_lambda(qp)
    cost = {}
    mode = {}
    mts = {}
    lfn = {}
    cmode = {}
    ispd = {}
    szs = [bw for (bw, bh) in _as_shapes(sizes)]
    for s in szs:
        nx, ny = w // s, h // s
        cost[s] = np.full((ny, nx), np.inf, dtype=np.float64)
        mode[s] = np.zeros((ny, nx), dtype=np.int32)
        mts[s] = np.zeros((ny, nx), dtype=np.int32)
        lfn[s] = np.zeros((ny, nx), dtype=np.int32)
        cmode[s] = np.zeros((ny, nx), dtype=np.int32)
        ispd[s] = np.zeros((ny, nx), dtype=np.int32)
        if (s, s) in results:
            r = results[(s, s)]
            cost[s][:] = r[0]
            mode[s][:] = r[1]
            mts[s][:] = r[2]
            if len(r) > 3:
                lfn[s][:] = r[3]
            if len(r) > 4:
                cmode[s][:] = r[4]
            if len(r) > 5:
                ispd[s][:] = r[5]

    # bottom-up DP
    best = {min_cu: cost[min_cu].copy()}
    use_split = {}
    for s in szs[1:] if szs[0] == min_cu else sorted(szs)[1:]:
        half = s // 2
        ny, nx = h // s, w // s
        ch = best[half]
        child_sum = (ch[0::2, 0::2][:ny, :nx] + ch[0::2, 1::2][:ny, :nx]
                     + ch[1::2, 0::2][:ny, :nx] + ch[1::2, 1::2][:ny, :nx])
        split_cost = child_sum + lam * SPLIT_BITS
        leaf_cost = cost[s][:ny, :nx] + lam * SPLIT_LEAF_BITS  # flag = 0
        use_split[s] = split_cost < leaf_cost
        best[s] = np.where(use_split[s], split_cost, leaf_cost)

    # backtrack in z-order over the CTU grid (implicit splits at borders)
    split_map = {}
    leaf_map = {}
    leaves = []

    def walk(x0, y0, s):
        if x0 >= w or y0 >= h:
            return
        if s > 64:
            # MaxCUSize 64: CTU-128 nodes split implicitly (no flag)
            half = s // 2
            for dx, dy in ((0, 0), (half, 0), (0, half), (half, half)):
                walk(x0 + dx, y0 + dy, half)
            return
        inside = x0 + s <= w and y0 + s <= h
        if not inside:
            half = s // 2
            for dx, dy in ((0, 0), (half, 0), (0, half), (half, half)):
                walk(x0 + dx, y0 + dy, half)
            return
        if s > min_cu and use_split[s][y0 // s, x0 // s]:
            split_map[(x0, y0, s, s)] = SPLIT_QT
            half = s // 2
            for dx, dy in ((0, 0), (half, 0), (0, half), (half, half)):
                walk(x0 + dx, y0 + dy, half)
        else:
            if s > min_cu:
                split_map[(x0, y0, s, s)] = SPLIT_NONE
            leaf = Leaf(x0, y0, s, s, int(mode[s][y0 // s, x0 // s]),
                        mts=int(mts[s][y0 // s, x0 // s]),
                        lfnst=int(lfn[s][y0 // s, x0 // s]),
                        isp=int(ispd[s][y0 // s, x0 // s]),
                        chroma_mode=int(cmode[s][y0 // s, x0 // s]))
            tr = _trace()
            if tr.enabled:
                tr.emit("BEST_MODE", x=x0, y=y0, w=s, h=s,
                        mode=leaf.luma_mode,
                        cost=float(cost[s][y0 // s, x0 // s]))
            leaf_map[(x0, y0, s, s)] = leaf
            leaves.append(leaf)

    for cy in range(0, h, ctu_size):
        for cx in range(0, w, ctu_size):
            walk(cx, cy, ctu_size)
    return split_map, leaf_map, leaves


def _dp_backtrack_mtt(results, w, h, qp, shapes, ctu_size, min_cu):
    """Shape-lattice DP over QT + BT + TT: two tables per shape — best_q
    (QT still allowed) and best_m (inside MTT, the spec's no-QT-below-MTT
    rule) — then a z-order backtrack emitting split codes (reference:
    EncCu::xCheckModeSplit over canSplit results).

    BT children of an aligned (w,h) grid land on the (w',h') grid.  TT
    outer children also align (offsets 0 and 3h/4 on the (w,h/4) grid and
    recurse through best_m); only the middle child sits at the +h/4
    half-offset, for which eval_mid_plane supplies LEAF-only cost planes
    (the middle child is not split further in the search — a bounded
    approximation; syntax/decode support arbitrary TT subtrees)."""
    from vvc_torch.model.partition import allowed_splits, SPLIT_TT_H, SPLIT_TT_V
    lam = rd_lambda(qp)
    shapes = _as_shapes(shapes)
    data = {}
    for sh in shapes:
        bw, bh = sh
        ny, nx = h // bh, w // bw
        if not (ny and nx):
            continue
        if sh in results:
            r = results[sh]
            data[sh] = tuple(np.asarray(x) for x in r)
        else:
            data[sh] = (np.full((ny, nx), np.inf, np.float64),
                        np.zeros((ny, nx), np.int32),
                        np.zeros((ny, nx), np.int32),
                        np.zeros((ny, nx), np.int32),
                        np.zeros((ny, nx), np.int32),
                        np.zeros((ny, nx), np.int32))

    # process smallest-area first so children exist before parents
    order = sorted(data.keys(), key=lambda sh: (sh[0] * sh[1], sh[0]))
    best_m, choice_m = {}, {}
    best_q, choice_q = {}, {}

    def bt_costs(tbl, sh):
        """(bt_h, bt_v) child-sum planes for shape sh from table tbl."""
        bw, bh = sh
        ny, nx = h // bh, w // bw
        out = []
        ch_h = tbl.get((bw, bh >> 1))
        out.append(None if ch_h is None else
                   ch_h[0::2, :][:ny, :nx] + ch_h[1::2, :][:ny, :nx])
        ch_v = tbl.get((bw >> 1, bh))
        out.append(None if ch_v is None else
                   ch_v[:, 0::2][:ny, :nx] + ch_v[:, 1::2][:ny, :nx])
        return out

    def tt_costs(tbl, sh):
        """(tt_h, tt_v) child-sum planes: outer children from the aligned
        quarter-shape best_m table, middle child from the leaf-only
        half-offset plane (results[('TH'|'TV', dim)])."""
        if not TT_IN_SEARCH:
            return [None, None]
        bw, bh = sh
        ny, nx = h // bh, w // bw
        out = []
        # the mid leaf pays its own split_cu_flag like every best_m leaf
        q_h = tbl.get((bw, bh >> 2))
        mid_h = results.get(("TH", bw)) if bh == 32 else None
        if q_h is None or mid_h is None:
            out.append(None)
        else:
            out.append(q_h[0::4, :][:ny, :nx] + q_h[3::4, :][:ny, :nx]
                       + mid_h[0][:ny, :nx] + lam * SPLIT_LEAF_BITS)
        q_v = tbl.get((bw >> 2, bh))
        mid_v = results.get(("TV", bh)) if bw == 32 else None
        if q_v is None or mid_v is None:
            out.append(None)
        else:
            out.append(q_v[:, 0::4][:ny, :nx] + q_v[:, 3::4][:ny, :nx]
                       + mid_v[0][:ny, :nx] + lam * SPLIT_LEAF_BITS)
        return out

    for sh in order:
        bw, bh = sh
        ny, nx = h // bh, w // bw
        leaf = data[sh][0].astype(np.float64)
        # ---- MTT-context table (QT barred) ----
        _, mbth, mbtv, mtth, mttv = allowed_splits(bw, bh, False, True)
        cands = [leaf + lam * SPLIT_LEAF_BITS]  # choice 0 = leaf (flag=0)
        codes = [SPLIT_NONE]
        sums = bt_costs(best_m, sh)
        tsums = tt_costs(best_m, sh)
        # direction flag coded only when both directions are available;
        # binary (BT-vs-TT) flag only when both compete in that direction
        dir_b = MTT_DIR_BITS if (mbth or mtth) and (mbtv or mttv) else 0.0
        if mbth and sums[0] is not None:
            cands.append(sums[0] + lam * (SPLIT_BITS + dir_b
                                          + (BT_FLAG_BITS if mtth else 0)))
            codes.append(SPLIT_BT_H)
        if mbtv and sums[1] is not None:
            cands.append(sums[1] + lam * (SPLIT_BITS + dir_b
                                          + (BT_FLAG_BITS if mttv else 0)))
            codes.append(SPLIT_BT_V)
        if mtth and tsums[0] is not None:
            cands.append(tsums[0] + lam * (SPLIT_BITS + dir_b
                                           + TT_MARGIN_BITS
                                           + (TT_FLAG_BITS if mbth else 0)))
            codes.append(SPLIT_TT_H)
        if mttv and tsums[1] is not None:
            cands.append(tsums[1] + lam * (SPLIT_BITS + dir_b
                                           + TT_MARGIN_BITS
                                           + (TT_FLAG_BITS if mbtv else 0)))
            codes.append(SPLIT_TT_V)
        stack = np.stack(cands)
        pick = np.argmin(stack, axis=0)
        best_m[sh] = np.take_along_axis(stack, pick[None], axis=0)[0]
        choice_m[sh] = np.asarray(codes, np.int32)[pick]
        # ---- QT-allowed table (square shapes only) ----
        if bw == bh:
            qt_ok, qbth, qbtv, qtth, qttv = allowed_splits(bw, bh, True, True)
            any_mtt = qbth or qbtv or qtth or qttv
            # split_qt_flag coded only when QT and MTT both compete
            qt_b = QT_FLAG_BITS if (qt_ok and any_mtt) else 0.0
            mtt_b = MTT_FLAG_BITS if qt_ok else 0.0
            qdir_b = (MTT_DIR_BITS
                      if (qbth or qtth) and (qbtv or qttv) else 0.0)
            cands = [leaf + lam * SPLIT_LEAF_BITS]
            codes = [SPLIT_NONE]
            if qt_ok and (bw >> 1, bh >> 1) in best_q:
                cq = best_q[(bw >> 1, bh >> 1)]
                qsum = (cq[0::2, 0::2][:ny, :nx] + cq[0::2, 1::2][:ny, :nx]
                        + cq[1::2, 0::2][:ny, :nx] + cq[1::2, 1::2][:ny, :nx])
                cands.append(qsum + lam * (SPLIT_BITS + qt_b))
                codes.append(SPLIT_QT)
            sums = bt_costs(best_m, sh)
            tsums = tt_costs(best_m, sh)
            if qbth and sums[0] is not None:
                cands.append(sums[0] + lam * (SPLIT_BITS + mtt_b + qdir_b
                                              + (BT_FLAG_BITS if qtth
                                                 else 0)))
                codes.append(SPLIT_BT_H)
            if qbtv and sums[1] is not None:
                cands.append(sums[1] + lam * (SPLIT_BITS + mtt_b + qdir_b
                                              + (BT_FLAG_BITS if qttv
                                                 else 0)))
                codes.append(SPLIT_BT_V)
            if qtth and tsums[0] is not None:
                cands.append(tsums[0] + lam * (SPLIT_BITS + mtt_b + qdir_b
                                               + TT_MARGIN_BITS
                                               + (TT_FLAG_BITS if qbth
                                                  else 0)))
                codes.append(SPLIT_TT_H)
            if qttv and tsums[1] is not None:
                cands.append(tsums[1] + lam * (SPLIT_BITS + mtt_b + qdir_b
                                               + TT_MARGIN_BITS
                                               + (TT_FLAG_BITS if qbtv
                                                  else 0)))
                codes.append(SPLIT_TT_V)
            stack = np.stack(cands)
            pick = np.argmin(stack, axis=0)
            best_q[sh] = np.take_along_axis(stack, pick[None], axis=0)[0]
            choice_q[sh] = np.asarray(codes, np.int32)[pick]

    split_map = {}
    leaf_map = {}
    leaves = []
    from vvc_torch.model.partition import child_blocks

    def walk(x0, y0, bw, bh, qt_allowed):
        if x0 >= w or y0 >= h:
            return
        if bw > 64 or bh > 64:
            # MaxCUSize 64: CTU-128 nodes split implicitly (no flag)
            half = bw >> 1
            for dx, dy in ((0, 0), (half, 0), (0, half), (half, half)):
                walk(x0 + dx, y0 + dy, half, half, qt_allowed)
            return
        if not (x0 + bw <= w and y0 + bh <= h):
            half = bw >> 1
            for dx, dy in ((0, 0), (half, 0), (0, half), (half, half)):
                walk(x0 + dx, y0 + dy, half, half, qt_allowed)
            return
        sh = (bw, bh)
        tbl = choice_q if (qt_allowed and bw == bh) else choice_m
        code = int(tbl[sh][y0 // bh, x0 // bw]) if sh in tbl else SPLIT_NONE
        if any(allowed_splits(bw, bh, qt_allowed, True)):
            split_map[(x0, y0, bw, bh)] = code
        if code == SPLIT_NONE:
            r = data[sh]
            iy, ix = y0 // bh, x0 // bw
            leaf = Leaf(x0, y0, bw, bh, int(r[1][iy, ix]),
                        mts=int(r[2][iy, ix]), lfnst=int(r[3][iy, ix]),
                        chroma_mode=int(r[4][iy, ix]),
                        isp=int(r[5][iy, ix]) if len(r) > 5 else 0)
            leaf_map[(x0, y0, bw, bh)] = leaf
            leaves.append(leaf)
            return
        kids = child_blocks(x0, y0, bw, bh, code)
        if code in (SPLIT_TT_H, SPLIT_TT_V):
            # middle child: leaf directly from the half-offset plane (its
            # position is off the aligned grids)
            cx, cy, cw, ch = kids[1]
            r = results[("TH", bw) if code == SPLIT_TT_H else ("TV", bh)]
            iy = cy // 32 if code == SPLIT_TT_H else cy // ch
            ix = cx // cw if code == SPLIT_TT_H else cx // 32
            leaf = Leaf(cx, cy, cw, ch, int(r[1][iy, ix]),
                        mts=int(r[2][iy, ix]), lfnst=int(r[3][iy, ix]))
            walk(*kids[0], False)
            if any(allowed_splits(cw, ch, False, True)):
                split_map[(cx, cy, cw, ch)] = SPLIT_NONE
            leaf_map[(cx, cy, cw, ch)] = leaf
            leaves.append(leaf)
            walk(*kids[2], False)
            return
        for (cx, cy, cw, ch) in kids:
            walk(cx, cy, cw, ch, code == SPLIT_QT and qt_allowed)

    for cy in range(0, h, ctu_size):
        for cx in range(0, w, ctu_size):
            walk(cx, cy, ctu_size, ctu_size, True)
    return split_map, leaf_map, leaves

"""Hadamard SATD, batched for the RDO prescreen.

Port of vvc/kernels/satd.py:37 `satd_batch` (reference: RdCost.cpp →
xGetHADs / xCalcHADs8x8): 8×8 Hadamard tiles when min(H, W) >= 8, the
whole-side 4-point transform otherwise, VTM normalisation per tile.

`satd_batch(a, b)` takes a [N,H,W] × [N,H,W] → [N], or a [N,M,H,W]
batch of predictions against [N,H,W] originals → [N,M] (the originals are
broadcast by index, never copied).  On a CUDA tensor it launches the CUDA
kernel `vvc_torch/csrc/satd.cu`; on a CPU tensor, or inside `ops.plain()`,
it runs `satd_batch_plain`, which does the same integer butterflies with
tensor ops.

`sse_batch` and `sad_batch` (vvc/kernels/satd.py:26,33) run on a CUDA
tensor as the kernel `block_dist` of the same source (an SSE and a SAD
mode), on a CPU tensor as `sse_batch_plain` / `sad_batch_plain`.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from vvc_torch import ops


@lru_cache(maxsize=None)
def hadamard(n: int) -> np.ndarray:
    if n == 1:
        return np.array([[1]], dtype=np.int32)
    h = hadamard(n // 2)
    return np.block([[h, h], [h, -h]]).astype(np.int32)


def _tile(hh: int, ww: int) -> int:
    return 8 if min(hh, ww) >= 8 else min(hh, ww)


def _fwht(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Fast Walsh-Hadamard transform along `dim` (Sylvester order, the
    same rows as `hadamard(n)`), integer-exact."""
    n = x.shape[dim]
    x = x.movedim(dim, -1)
    lead = x.shape[:-1]
    span = 1
    while span < n:
        v = x.reshape(*lead, n // (2 * span), 2, span)
        a, b = v[..., 0, :], v[..., 1, :]
        x = torch.stack([a + b, a - b], dim=-2).reshape(*lead, n)
        span *= 2
    return x.movedim(-1, dim)


def satd_batch_plain(pred: torch.Tensor, orig: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch SATD: pred [..., H, W] against orig broadcastable to
    it → [...] int32."""
    hh, ww = pred.shape[-2:]
    t = _tile(hh, ww)
    d = (pred.to(torch.int32) - orig.to(torch.int32))
    lead = d.shape[:-2]
    d = d.reshape(*lead, hh // t, t, ww // t, t)
    had = _fwht(_fwht(d, -3), -1)
    per_tile = had.abs().sum(dim=(-3, -1), dtype=torch.int32)
    if t == 8:
        per_tile = (per_tile + 2) >> 2
    else:
        per_tile = (per_tile + 1) >> 1
    return per_tile.sum(dim=(-2, -1), dtype=torch.int32)


def _satd_cuda(pred: torch.Tensor, orig: torch.Tensor) -> torch.Tensor:
    ops.check_cuda_i32("satd", pred, orig)
    n, m, hh, ww = pred.shape
    if orig.shape != (n, hh, ww):
        raise ValueError(f"satd: orig {tuple(orig.shape)} does not match "
                         f"pred {tuple(pred.shape)}")
    t = _tile(hh, ww)
    if t not in (4, 8) or hh % t or ww % t:
        raise ValueError(f"satd: unsupported block {hh}x{ww}")
    tiles = (hh // t) * (ww // t)
    out = (torch.zeros if tiles > 32 else torch.empty)(
        (n, m), dtype=torch.int32, device=pred.device)
    fn = ops.lib("satd").satd_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(pred.data_ptr(), orig.data_ptr(), out.data_ptr(), n, m, hh, ww,
             ops.stream_ptr(pred))
    ops.launched("satd", err)
    return out


def satd_batch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[N,H,W] × [N,H,W] → [N], or [N,M,H,W] × [N,H,W] → [N,M] int32."""
    if a.dim() == 3:
        if b.shape != a.shape:
            raise ValueError("satd_batch: a and b shapes differ")
        return satd_batch(a[:, None], b)[:, 0]
    if ops.use_kernel(a):
        return _satd_cuda(a, b)
    return satd_batch_plain(a, b[:, None])


# ---------------------------------------------------------------------------
# SSE and SAD


def _seq_f32(x: torch.Tensor) -> torch.Tensor:
    """[M, K] float32 → [M], summed left to right from 0 in float32."""
    acc = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
    for j in range(x.shape[1]):
        acc = acc + x[:, j]
    return acc


def sse_f32(d: torch.Tensor, lanes8: bool = True) -> torch.Tensor:
    """Σ d² per [M, H, W] integer difference block as vvc's eager
    `sse_batch` sums it in float32 (XLA-CPU, jax 0.9.0, read from the
    object code of the eager reduce).  Below 2^24 every order gives the
    exact integer; above: 8×8 row lanes (lane r sums row r left to right,
    then the halving tree; `lanes8=False`: row-major, the order of vvc's
    window search), 64×64 four 32×32 windows each row-major from 0 then
    (W00 + W01) + (W10 + W11), every other shape row-major from 0."""
    m, h, w = d.shape
    dl = d.to(torch.int64)
    exact = (dl * dl).sum(dim=(1, 2))
    out = exact.to(torch.float32)
    big = exact >= (1 << 24)
    if bool(big.any()):
        sq = (dl[big] * dl[big]).to(torch.float32)
        if lanes8 and (h, w) == (8, 8):
            lanes = torch.stack([_seq_f32(sq[:, r]) for r in range(8)], -1)
            out[big] = (((lanes[:, 0] + lanes[:, 4])
                         + (lanes[:, 2] + lanes[:, 6]))
                        + ((lanes[:, 1] + lanes[:, 5])
                           + (lanes[:, 3] + lanes[:, 7])))
        elif (h, w) == (64, 64):
            win = [_seq_f32(sq[:, i:i + 32, j:j + 32].reshape(-1, 1024))
                   for i in (0, 32) for j in (0, 32)]
            out[big] = (win[0] + win[1]) + (win[2] + win[3])
        else:
            out[big] = _seq_f32(sq.reshape(-1, h * w))
    return out


def sse_batch_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain twin of vvc/kernels/satd.py:26 `sse_batch`: [N, H, W] → [N]
    float32 (see `sse_f32` for the order)."""
    return sse_f32(a.to(torch.int32) - b.to(torch.int32))


def sad_batch_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain twin of vvc/kernels/satd.py:33 `sad_batch`: [N, H, W] → [N]
    int32 Σ |a − b|."""
    return (a.to(torch.int32) - b.to(torch.int32)).abs().sum(
        dim=(-2, -1), dtype=torch.int32)


def _block_dist_cuda(a: torch.Tensor, b: torch.Tensor, sad: bool):
    ops.check_cuda_i32("block_dist", a, b)
    if a.dim() != 3 or a.shape != b.shape:
        raise ValueError(f"block_dist: shapes {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    n, h, w = a.shape
    out = torch.empty(n, dtype=torch.int32 if sad else torch.float32,
                      device=a.device)
    fn = ops.lib("block_dist").block_dist_launch
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    err = fn(a.data_ptr(), b.data_ptr(), n, h, w, int(sad),
             0 if sad else out.data_ptr(), out.data_ptr() if sad else 0,
             ops.stream_ptr(a))
    ops.launched("block_dist", err)
    return out


def sse_batch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[N, H, W] × [N, H, W] → [N] float32 SSE.  CUDA tensors →
    vvc_torch/csrc/satd.cu `block_dist`; CPU tensors or `ops.plain()` →
    sse_batch_plain."""
    if ops.use_kernel(a):
        return _block_dist_cuda(a.to(torch.int32).contiguous(),
                                b.to(torch.int32).contiguous(), False)
    return sse_batch_plain(a, b)


def sad_batch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[N, H, W] × [N, H, W] → [N] int32 SAD.  CUDA tensors → `block_dist`;
    CPU tensors or `ops.plain()` → sad_batch_plain."""
    if ops.use_kernel(a):
        return _block_dist_cuda(a.to(torch.int32).contiguous(),
                                b.to(torch.int32).contiguous(), True)
    return sad_batch_plain(a, b)

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

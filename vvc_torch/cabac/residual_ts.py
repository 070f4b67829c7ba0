"""Transform-skip residual coding (spec 7.3.10.11 residual_ts_coding).

TPU-native analog of the reference's TS residual path
(`VTM/source/Lib/EncoderLib/CABACWriter.cpp` →
residual_codingTS / residual_coding_subblockTS;
DecoderLib/CABACReader.cpp mirror; QuantRDOQ.cpp → xRateDistOptQuantTS).

Differences from the regular coder (vvc_torch.cabac.residual) that this module
keeps: FORWARD scan (DC-first, no last-position), per-CG coded flag with
the spec's all-zero-so-far inference on the final CG, context-coded signs,
and the remBinsPass1 context-bin budget (MaxCcbs = (w·h·7)>>2) after which
levels fall back to fully-bypass coding.  Level decomposition reuses the
repo-wide mapping |a| = 1 + gt1 + par + 2·gt3 + 2·rem.  Context
identities/counts are simplified vs the spec ([verify] — SURVEY §0);
writer and reader mirror exactly, which is what bit-exactness rests on.
"""
from __future__ import annotations

import numpy as np

from vvc_torch.cabac.residual import full_scan_rect


def _eg_write(enc, v: int, k: int):
    """Exp-Golomb order-k bypass (same shape as cu_syntax._eg_write; local
    copy avoids a circular import — cu_syntax imports this module)."""
    while v >= (1 << k):
        enc.encode_bin_ep(1)
        v -= 1 << k
        k += 1
    enc.encode_bin_ep(0)
    if k:
        enc.encode_bins_ep(v, k)


def _eg_read(dec, k: int) -> int:
    v = 0
    while dec.decode_bin_ep():
        v += 1 << k
        k += 1
    if k:
        v += dec.decode_bins_ep(k)
    return v


def _cg_geometry(w: int, h: int):
    """→ (scan, cg_of, n_cg): forward scan + coefficient-group index per
    scan position (16-coefficient groups when both sides >= 4, else one
    group per whole block)."""
    from vvc_torch.kernels.quant import _log2
    scan = full_scan_rect(_log2(w), _log2(h))
    if w < 4 or h < 4:
        return scan, [0] * len(scan), 1
    n_cg = len(scan) // 16
    return scan, [i // 16 for i in range(len(scan))], n_cg


def _budget(w: int, h: int) -> int:
    return (w * h * 7) >> 2          # spec MaxCcbs


def write_residual_ts(enc, ctxs, levels: np.ndarray, is_luma: bool,
                      bdpcm: int = 0):
    h, w = levels.shape
    scan, cg_of, n_cg = _cg_geometry(w, h)
    sig = np.zeros((h, w), dtype=np.int8)
    budget = _budget(w, h)
    bd = 1 if bdpcm else 0
    # per-CG coded flags (forward CG order); last CG inferred 1 when all
    # previous are 0 (spec: guarantees a coded CG for cbf=1 blocks)
    cg_has = [False] * n_cg
    for i, (x, y) in enumerate(scan):
        if levels[y, x]:
            cg_has[cg_of[i]] = True
    prev_flag = 0
    any_coded = False
    for g in range(n_cg):
        infer = (g == n_cg - 1) and not any_coded
        if not infer:
            enc.encode_bin(int(cg_has[g]), ctxs("TS_SB", prev_flag))
        prev_flag = int(cg_has[g])
        any_coded = any_coded or cg_has[g]
        if not cg_has[g]:
            continue
        for i in range(g * 16, g * 16 + 16) if n_cg > 1 else range(len(scan)):
            x, y = scan[i]
            a = abs(int(levels[y, x]))
            if budget >= 4:
                sl = sig[y, x - 1] if x > 0 else 0
                sa = sig[y - 1, x] if y > 0 else 0
                enc.encode_bin(1 if a else 0, ctxs("TS_SIG", int(sl + sa)))
                budget -= 1
                if a:
                    sig[y, x] = 1
                    enc.encode_bin(1 if levels[y, x] < 0 else 0,
                                   ctxs("TS_SIGN", bd))
                    gt1 = a > 1
                    enc.encode_bin(int(gt1), ctxs("TS_GT1", bd))
                    budget -= 2
                    if gt1:
                        par = (a - 2) & 1
                        enc.encode_bin(par, ctxs("TS_PAR", 0))
                        gt3 = a >= 4
                        enc.encode_bin(int(gt3), ctxs("TS_GT3", bd))
                        budget -= 2
                        if gt3:
                            _eg_write(enc, (a - 4 - par) >> 1, 1)
            else:
                # budget exhausted: fully-bypass coding (spec dec_abs_level
                # fallback shape): EG1 magnitude + EP sign
                _eg_write(enc, a, 1)
                if a:
                    enc.encode_bin_ep(1 if levels[y, x] < 0 else 0)
                    sig[y, x] = 1


def read_residual_ts(dec, ctxs, size, is_luma: bool,
                     bdpcm: int = 0) -> np.ndarray:
    w, h = size
    scan, cg_of, n_cg = _cg_geometry(w, h)
    out = np.zeros((h, w), dtype=np.int32)
    sig = np.zeros((h, w), dtype=np.int8)
    budget = _budget(w, h)
    bd = 1 if bdpcm else 0
    prev_flag = 0
    any_coded = False
    for g in range(n_cg):
        infer = (g == n_cg - 1) and not any_coded
        if infer:
            has = 1
        else:
            has = dec.decode_bin(ctxs("TS_SB", prev_flag))
        prev_flag = has
        any_coded = any_coded or bool(has)
        if not has:
            continue
        for i in range(g * 16, g * 16 + 16) if n_cg > 1 else range(len(scan)):
            x, y = scan[i]
            if budget >= 4:
                sl = sig[y, x - 1] if x > 0 else 0
                sa = sig[y - 1, x] if y > 0 else 0
                s = dec.decode_bin(ctxs("TS_SIG", int(sl + sa)))
                budget -= 1
                if not s:
                    continue
                sig[y, x] = 1
                neg = dec.decode_bin(ctxs("TS_SIGN", bd))
                gt1 = dec.decode_bin(ctxs("TS_GT1", bd))
                budget -= 2
                a = 1
                if gt1:
                    par = dec.decode_bin(ctxs("TS_PAR", 0))
                    gt3 = dec.decode_bin(ctxs("TS_GT3", bd))
                    budget -= 2
                    a = 2 + par
                    if gt3:
                        a += 2 + 2 * _eg_read(dec, 1)
                out[y, x] = -a if neg else a
            else:
                a = _eg_read(dec, 1)
                if a:
                    neg = dec.decode_bin_ep()
                    out[y, x] = -a if neg else a
                    sig[y, x] = 1
    return out

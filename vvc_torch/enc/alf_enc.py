"""ALF encoder: Wiener solve + per-CTU on/off RD decisions.

TPU-native analog of the reference's ALF encoder
(`VTM/source/Lib/EncoderLib/EncAdaptiveLoopFilter.cpp` →
deriveStatsForFiltering (covariances) / deriveFilterCoeffs (Cholesky
solve) / alfEncoderCtb (CTB on/off RD)).  The normal equations
  (F Fᵀ) c = F (orig − rec)
are accumulated over the whole picture — covariance reductions are the
device-friendly shape; the 12×12 solve is trivial host work.

Port of vvc/enc/alf_enc.py: the luma statistics run on `device` through
vvc_torch.kernels.alf.alf_stats_dev (csrc/alf_stats.cu on CUDA) and come
back as float64, as vvc's do; the solves, the class merging, the clip
choice and the CTU flags are vvc's host code, copied (their float32 numpy
products included).
"""
from __future__ import annotations

import numpy as np
import torch

from vvc_torch.kernels.alf import pair_features, alf_delta, ALF_SHIFT
from vvc_torch.enc.rdo import rd_lambda
from vvc_torch.ops import resolve_device

MAX_COEFF = 127  # 7-bit signed (reference coefficient range)


def derive_alf_coeffs(orig: np.ndarray, rec: np.ndarray, radius: int,
                      feats=None):
    """Least-squares filter coefficients (int, 1<<7 scale), or None if the
    system is degenerate."""
    f = feats if feats is not None else pair_features(rec, radius)
    n = f.shape[0]
    fm = f.reshape(n, -1).astype(np.float32)
    t = (orig - rec).reshape(-1).astype(np.float32)
    a = (fm @ fm.T).astype(np.float64)
    b = (fm @ t).astype(np.float64)
    try:
        c = np.linalg.solve(a + np.eye(n) * 1e-3, b)
    except np.linalg.LinAlgError:
        return None
    ci = np.clip(np.round(c * (1 << ALF_SHIFT)), -MAX_COEFF, MAX_COEFF)
    if not np.any(ci):
        return None
    return ci.astype(np.int32)


def _solve(a, b, n):
    try:
        c = np.linalg.solve(a + np.eye(n) * 1e-3, b)
    except np.linalg.LinAlgError:
        return None
    return np.clip(np.round(c * (1 << ALF_SHIFT)), -MAX_COEFF,
                   MAX_COEFF).astype(np.int32)


def derive_classified_filters(o: np.ndarray, r: np.ndarray, qp: int,
                              bit_depth: int, device=None):
    """25-class stats → greedy class merging → (coeffs [nf,12],
    clips [nf], fmap [25], cls4, tr4) or None.

    Reference: EncAdaptiveLoopFilter::deriveFilterCoeffs — per-class
    covariances (with the geometric transpose folded into the features),
    then classes merged while the RD cost (Σ residual err + λ·filter
    rate) improves.  Clip level per filter chosen by direct SSE test.
    device: where the statistics run (None = CUDA, raising without it)."""
    from vvc_torch.kernels.alf import (alf_classify, pair_transpose_perms,
                                       alf_stats_dev)
    device = resolve_device(device)
    lam = rd_lambda(qp)
    cls4, tr4 = alf_classify(r, bit_depth)
    h, w = o.shape
    npair = 12
    perms = pair_transpose_perms(3)
    # per-(class, transpose) normal equations on a 2×2-subsampled grid,
    # accumulated on the device (one `alf_stats` launch on CUDA); the
    # geometric transpose becomes a 12×12 index permutation applied to
    # each group's raw covariance (A'[i,j] = a[P[i],P[j]])
    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

    A100, B100, sse0_d, npx_d = (
        s.cpu().numpy() for s in alf_stats_dev(dev(o), dev(r), dev(cls4),
                                               dev(tr4)))
    A100 = np.asarray(A100, np.float64)
    B100 = np.asarray(B100, np.float64)
    A = np.zeros((25, npair, npair))
    B = np.zeros((25, npair))
    for b in range(100):
        P = perms[b & 3]
        A[b >> 2] += A100[b][np.ix_(P, P)]
        B[b >> 2] += B100[b][P]
    sse0 = np.asarray(sse0_d, np.float64)
    npx = np.asarray(npx_d, np.float64)
    # rescale to full-plane magnitudes so err and λ·rate stay comparable
    A *= 4.0
    B *= 4.0
    sse0 *= 4.0

    def group_err(a, b, s0):
        c = _solve(a, b, npair)
        if c is None:
            return s0, None
        cf = c.astype(np.float64) / (1 << ALF_SHIFT)
        # LS residual with the quantized coefficients
        return s0 - 2 * cf @ b + cf @ a @ cf, c

    # greedy pair merging over filter groups (reference mergeClasses)
    groups = [[k] for k in range(25) if npx[k] > 0]
    if not groups:
        return None
    stats = {tuple(g): (A[g[0]].copy(), B[g[0]].copy(), sse0[g[0]])
             for g in groups}
    FILT_BITS = npair * 6.0 + 2.0

    def total_cost(gs):
        err = 0.0
        cs = []
        for g in gs:
            a, b, s0 = stats[tuple(g)]
            e, c = group_err(a, b, s0)
            if c is None:
                c = np.zeros(npair, np.int32)
                e = s0
            err += e
            cs.append(c)
        return err + lam * (len(gs) * FILT_BITS + 25 * 3.0), cs

    best_cost, best_cs = total_cost(groups)
    best_groups = [list(g) for g in groups]
    cur = [list(g) for g in groups]
    def float_err_batch(As, Bs, S0s):
        """Batched unquantized LS residuals for merge-pair screening."""
        n = As.shape[0]
        eye = np.eye(npair) * 1e-3
        try:
            cs = np.linalg.solve(As + eye[None], Bs[:, :, None])[:, :, 0]
        except np.linalg.LinAlgError:
            return np.full(n, np.inf)
        return S0s - np.einsum("ki,ki->k", cs, Bs)

    while len(cur) > 1:
        # merge the cheapest pair (merged-group error increase, batched
        # float solves for screening; quantized solve only on adoption)
        m = len(cur)
        errs = float_err_batch(
            np.stack([stats[tuple(g)][0] for g in cur]),
            np.stack([stats[tuple(g)][1] for g in cur]),
            np.array([stats[tuple(g)][2] for g in cur]))
        ii, jj = np.triu_indices(m, 1)
        Ap = np.stack([stats[tuple(cur[i])][0] + stats[tuple(cur[j])][0]
                       for i, j in zip(ii, jj)])
        Bp = np.stack([stats[tuple(cur[i])][1] + stats[tuple(cur[j])][1]
                       for i, j in zip(ii, jj)])
        Sp = np.array([stats[tuple(cur[i])][2] + stats[tuple(cur[j])][2]
                       for i, j in zip(ii, jj)])
        inc = float_err_batch(Ap, Bp, Sp) - errs[ii] - errs[jj]
        k = int(np.argmin(inc))
        i, j = int(ii[k]), int(jj[k])
        g = sorted(cur[i] + cur[j])
        stats[tuple(g)] = (Ap[k], Bp[k], Sp[k])
        cur = [g0 for k0, g0 in enumerate(cur) if k0 not in (i, j)] + [g]
        c, cs = total_cost(cur)
        if c < best_cost:
            best_cost, best_cs = c, cs
            best_groups = [list(g0) for g0 in cur]

    nf = len(best_groups)
    coeffs = np.stack(best_cs) if best_cs else None
    if coeffs is None or not np.any(coeffs):
        return None
    fmap = np.zeros(25, np.int32)
    for fi, g in enumerate(best_groups):
        for k in g:
            fmap[k] = fi
    # clip level per filter: direct SSE test over {off, 3 strengths} —
    # all candidates evaluated in ONE pass over the taps (shared gathers)
    from vvc_torch.kernels.alf import (diamond_pairs as _dp,
                                       pair_transpose_perms as _ptp)
    cand = np.array([0, 1 << max(0, bit_depth - 3),
                     1 << max(0, bit_depth - 5),
                     1 << max(0, bit_depth - 7)], np.int32)
    maxv = (1 << bit_depth) - 1
    # selection on the same 2×2-subsampled grid as the stats (full-res
    # neighbours — only the evaluated output positions are strided)
    fpx2 = fmap[np.repeat(np.repeat(cls4, 4, 0), 4, 1)[:h, :w]][::2, ::2]
    tpx2 = np.repeat(np.repeat(tr4, 4, 0), 4, 1)[:h, :w][::2, ::2]
    perms2 = _ptp(3)
    p3 = np.pad(r.astype(np.int32), 3, mode="edge")
    r32 = r.astype(np.int32)[::2, ::2]
    hs, ws = r32.shape
    accs = [np.full((hs, ws), 1 << (ALF_SHIFT - 1), np.int64)
            for _ in range(4)]
    bounds = [np.int32(1 << 17), cand[1], cand[2], cand[3]]
    for i, ((ady, adx), (bdy, bdx)) in enumerate(_dp(3)):
        na = p3[3 + ady:3 + ady + h:2, 3 + adx:3 + adx + w:2]
        nb = p3[3 + bdy:3 + bdy + h:2, 3 + bdx:3 + bdx + w:2]
        da = na - r32
        db = nb - r32
        ci = coeffs[fpx2, perms2[tpx2, i]]
        for c in range(4):
            b = bounds[c]
            accs[c] += ci * (np.clip(da, -b, b)
                             + np.clip(db, -b, b)).astype(np.int64)
    clips = np.zeros(nf, np.int32)
    err_now = None
    o64 = o.astype(np.int64)[::2, ::2]
    for c in range(4):
        d = (accs[c] >> ALF_SHIFT).astype(np.int32)
        e2 = (o64 - np.clip(r32 + d, 0, maxv)) ** 2
        per_f = np.bincount(fpx2.ravel(), e2.ravel(), minlength=nf)[:nf]
        if err_now is None:
            err_now = per_f
        else:
            upd = per_f < err_now
            err_now = np.where(upd, per_f, err_now)
            clips = np.where(upd, cand[c], clips).astype(np.int32)
    return coeffs, clips, fmap, cls4, tr4


def decide_alf_frame(orig_planes, recon_planes, qp: int, bit_depth: int,
                     ctu_size: int, device=None):
    """Returns (luma|None, ctu_flags, chroma_coeffs|None, luma_delta)
    where luma = (coeffs [nf,12], clips [nf], fmap [25]) and ctu_flags
    {(x0,y0): bool}; luma_delta is the precomputed whole-plane filter
    delta (reused by the caller's apply — it was already computed for the
    CTU gain map).  Chroma: one 5×5 filter shared by cb/cr.  device:
    where the luma statistics run (None = CUDA, raising without it)."""
    lam = rd_lambda(qp)
    o, r = orig_planes[0], recon_planes[0]
    h, w = o.shape
    flags = {}
    luma = None
    luma_delta = None
    res = derive_classified_filters(o, r, qp, bit_depth, device)
    if res is not None:
        coeffs, clips, fmap, cls4, tr4 = res
        from vvc_torch.kernels.alf import alf_delta_classified
        delta = alf_delta_classified(r, coeffs, clips, fmap, cls4, tr4)
        filtered_err = (o.astype(np.int64)
                        - np.clip(r + delta, 0, (1 << bit_depth) - 1)) ** 2
        plain_err = (o.astype(np.int64) - r) ** 2
        total_gain = 0.0
        for y0 in range(0, h, ctu_size):
            for x0 in range(0, w, ctu_size):
                sl = np.s_[y0:min(y0 + ctu_size, h), x0:min(x0 + ctu_size, w)]
                d = float(plain_err[sl].sum() - filtered_err[sl].sum())
                on = d > lam  # 1-bit flag cost
                flags[(x0, y0)] = on
                if on:
                    total_gain += d - lam
        nf = coeffs.shape[0]
        if total_gain > lam * nf * 12 * 6:
            luma = (coeffs, clips, fmap)
            luma_delta = delta
        else:
            flags = {k: False for k in flags}
    else:
        for y0 in range(0, h, ctu_size):
            for x0 in range(0, w, ctu_size):
                flags[(x0, y0)] = False

    chroma = None
    oc = np.concatenate([orig_planes[1], orig_planes[2]], axis=0)
    rc = np.concatenate([recon_planes[1], recon_planes[2]], axis=0)
    cc = derive_alf_coeffs(oc, rc, 2)
    if cc is not None:
        d = alf_delta(rc, cc, 2)
        gain = float((((oc - rc) ** 2).sum()
                      - ((oc - np.clip(rc + d, 0, (1 << bit_depth) - 1)) ** 2).sum()))
        if gain > lam * 6 * 8:
            chroma = cc
    return luma, flags, chroma, luma_delta

"""Residual (transform-coefficient) CABAC coding — writer/reader pair.

TPU-native analog of the reference's residual coding
(`VTM/source/Lib/EncoderLib/CABACWriter.cpp` → residual_coding /
last_sig_coeff / residual_coding_subblock;
`source/Lib/DecoderLib/CABACReader.cpp` mirror;
`source/Lib/CommonLib/ContextModelling.h` → CoeffCodingContext:
sigCtxIdAbs / parityCtxIdAbs / gtxCtxIdAbs; Rom.cpp → g_uiGroupIdx /
g_uiMinInGroup).  OpenVVC counterpart: libovvc/vcl_tu.c residual parsing.

Structure (spec 7.3.10.11, non-transform-skip, dep-quant off):
  * last significant coefficient position (prefix ctx bins + EP suffix)
  * 4×4 coefficient groups in reverse diagonal scan: sb_coded_flag,
    then per group pass1 (sig / gt1 / par / gt3 interleaved, ctx from the
    5-neighbor template of partial levels), pass2 abs_remainder
    (Golomb-Rice, EP), then signs (EP).
Level mapping: |a| = 1 + gt1 + par + 2*gt3 + 2*rem.

Round-1 deviations from the spec, shared by writer+reader and flagged for
later alignment [verify]: no remBinsPass1 budget (pass-1 ctx bins always
coded; spec switches to dec_abs_level when the budget runs out), simplified
Rice-parameter thresholds, placeholder context init.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

from vvc_torch.rom.transform_mats import diag_scan


@lru_cache(maxsize=None)
def full_scan(log2s: int):
    """Forward scan of an S×S TB: CGs in diagonal order, 4×4 diag inside.

    Consecutive groups of 16 entries form one coefficient group.
    """
    return full_scan_rect(log2s, log2s)


@lru_cache(maxsize=None)
def full_scan_rect(log2w: int, log2h: int):
    """Forward scan of a W×H TB (rect general form of full_scan)."""
    w, h = 1 << log2w, 1 << log2h
    if w < 4 or h < 4:
        return tuple(diag_scan(w, h))
    inner = diag_scan(4, 4)
    out = []
    for cgx, cgy in diag_scan(w >> 2, h >> 2):
        for sx, sy in inner:
            out.append((cgx * 4 + sx, cgy * 4 + sy))
    return tuple(out)


def _group_idx(v: int) -> int:
    if v < 4:
        return v
    k = v.bit_length() - 1
    return (k << 1) + ((v >> (k - 1)) & 1)


def _min_in_group(g: int) -> int:
    if g < 4:
        return g
    return (2 + (g & 1)) << ((g >> 1) - 1)


def _last_ctx(bin_idx: int, log2s: int, is_luma: bool) -> int:
    if is_luma:
        offset = 3 * (log2s - 2) + ((log2s - 1) >> 2)
        shift = (log2s + 1) >> 2
    else:
        offset = 0
        shift = max(0, log2s - 2)
    return offset + (bin_idx >> shift)


def _sig_ctx(x: int, y: int, p1: np.ndarray, is_luma: bool) -> int:
    h, w = p1.shape
    acc = 0
    for dx, dy in ((1, 0), (2, 0), (0, 1), (0, 2), (1, 1)):
        nx, ny = x + dx, y + dy
        if nx < w and ny < h:
            acc += int(p1[ny, nx])
    diag = x + y
    if is_luma:
        base = 8 if diag < 2 else (4 if diag < 5 else 0)
    else:
        base = 4 if diag < 2 else 0
    return base + min((acc + 1) >> 1, 3)


def _gtx_ctx(x: int, y: int, p1: np.ndarray, is_luma: bool) -> int:
    h, w = p1.shape
    acc = 0
    for dx, dy in ((1, 0), (2, 0), (0, 1), (0, 2), (1, 1)):
        nx, ny = x + dx, y + dy
        if nx < w and ny < h:
            acc += int(p1[ny, nx])
    diag = x + y
    if is_luma:
        base = 10 if diag == 0 else (5 if diag < 3 else 0)
        return base + min(acc, 4)
    return min(acc, 4)


def _rice_param(x: int, y: int, full: np.ndarray) -> int:
    h, w = full.shape
    acc = 0
    for dx, dy in ((1, 0), (2, 0), (0, 1), (0, 2), (1, 1)):
        nx, ny = x + dx, y + dy
        if nx < w and ny < h:
            acc += int(full[ny, nx])
    if acc < 7:
        return 0
    if acc < 14:
        return 1
    if acc < 28:
        return 2
    return 3


# ---------------------------------------------------------------------------


def _write_golomb_rice(enc, rem: int, rice: int, thresh: int = 6):
    q = rem >> rice
    if q < thresh:
        for _ in range(q):
            enc.encode_bin_ep(1)
        enc.encode_bin_ep(0)
        if rice:
            enc.encode_bins_ep(rem & ((1 << rice) - 1), rice)
    else:
        for _ in range(thresh):
            enc.encode_bin_ep(1)
        v = rem - (thresh << rice)
        m = rice + 1
        while v >= (1 << m):
            enc.encode_bin_ep(1)
            v -= 1 << m
            m += 1
        enc.encode_bin_ep(0)
        enc.encode_bins_ep(v, m)


def _read_golomb_rice(dec, rice: int, thresh: int = 6) -> int:
    q = 0
    while q < thresh and dec.decode_bin_ep():
        q += 1
    if q < thresh:
        rem = q << rice
        if rice:
            rem |= dec.decode_bins_ep(rice)
        return rem
    m = rice + 1
    v = thresh << rice
    while dec.decode_bin_ep():
        v += 1 << m
        m += 1
    return v + dec.decode_bins_ep(m)


def write_last_pos(enc, ctxs, lx: int, ly: int, log2w: int, log2h: int,
                   is_luma: bool):
    set_x = "LAST_X_LUMA" if is_luma else "LAST_X_CHROMA"
    set_y = "LAST_Y_LUMA" if is_luma else "LAST_Y_CHROMA"
    for v, cset, lg in ((lx, set_x, log2w), (ly, set_y, log2h)):
        g = _group_idx(v)
        gmax = _group_idx((1 << lg) - 1)
        for i in range(min(g, gmax)):
            enc.encode_bin(1, ctxs(cset, _last_ctx(i, lg, is_luma)))
        if g < gmax:
            enc.encode_bin(0, ctxs(cset, _last_ctx(g, lg, is_luma)))
    for v in (lx, ly):
        g = _group_idx(v)
        if g > 3:
            nbits = (g >> 1) - 1
            enc.encode_bins_ep(v - _min_in_group(g), nbits)


def read_last_pos(dec, ctxs, log2w: int, log2h: int, is_luma: bool):
    set_x = "LAST_X_LUMA" if is_luma else "LAST_X_CHROMA"
    set_y = "LAST_Y_LUMA" if is_luma else "LAST_Y_CHROMA"
    groups = []
    for cset, lg in ((set_x, log2w), (set_y, log2h)):
        gmax = _group_idx((1 << lg) - 1)
        g = 0
        while g < gmax and dec.decode_bin(ctxs(cset, _last_ctx(g, lg, is_luma))):
            g += 1
        groups.append(g)
    out = []
    for g in groups:
        v = _min_in_group(g)
        if g > 3:
            v += dec.decode_bins_ep((g >> 1) - 1)
        out.append(v)
    return out[0], out[1]


def write_residual(enc, ctxs, levels: np.ndarray, is_luma: bool):
    """Encode one W×H block of quantized levels (must contain a nonzero)."""
    if hasattr(enc, "write_residual"):  # native packer fast path
        return enc.write_residual(ctxs, levels, is_luma)
    h, w = int(levels.shape[0]), int(levels.shape[1])
    log2w = w.bit_length() - 1
    log2h = h.bit_length() - 1
    scan = full_scan_rect(log2w, log2h)
    nposs = len(scan)

    last = -1
    for i in range(nposs - 1, -1, -1):
        x, y = scan[i]
        if levels[y, x] != 0:
            last = i
            break
    assert last >= 0, "write_residual on an all-zero block"
    lx, ly = scan[last]
    write_last_pos(enc, ctxs, lx, ly, log2w, log2h, is_luma)

    suf = "LUMA" if is_luma else "CHROMA"
    last_sb = last >> 4
    p1 = np.zeros((h, w), dtype=np.int32)      # partial levels (pass1 caps)
    full = np.zeros((h, w), dtype=np.int32)    # full abs levels
    sb_coded = np.zeros(((nposs + 15) >> 4,), dtype=np.int32)
    sb_w, sb_h = max(1, w >> 2), max(1, h >> 2)

    for sb in range(last_sb, -1, -1):
        sb_has = any(levels[scan[i][1], scan[i][0]] != 0
                     for i in range(sb * 16, min((sb + 1) * 16, nposs)))
        explicit = sb != last_sb and sb != 0
        if explicit:
            cgx, cgy = scan[sb * 16][0] >> 2, scan[sb * 16][1] >> 2
            nb = 0
            if cgx + 1 < sb_w and sb_coded[_cg_index(cgx + 1, cgy, sb_w, sb_h)]:
                nb = 1
            if cgy + 1 < sb_h and sb_coded[_cg_index(cgx, cgy + 1, sb_w, sb_h)]:
                nb = 1
            enc.encode_bin(1 if sb_has else 0, ctxs(f"SB_CODED_FLAG_{suf}", nb))
        sb_coded[sb] = 1 if (sb_has or not explicit) else 0
        if not sb_coded[sb]:
            continue

        start = last if sb == last_sb else min((sb + 1) * 16, nposs) - 1
        sig_found = False
        gt3_pos = []
        nz_pos = []
        for i in range(start, sb * 16 - 1, -1):
            x, y = scan[i]
            a = abs(int(levels[y, x]))
            if i == last:
                sig = 1
            else:
                infer_dc = explicit and (i == sb * 16) and not sig_found
                if infer_dc:
                    sig = 1
                    assert a > 0, "explicit coded sb with zero DC and no sig"
                else:
                    sig = 1 if a > 0 else 0
                    enc.encode_bin(sig, ctxs(f"SIG_{suf}", _sig_ctx(x, y, p1, is_luma)))
            if sig:
                sig_found = True
                nz_pos.append(i)
                gctx = _gtx_ctx(x, y, p1, is_luma)
                gt1 = 1 if a > 1 else 0
                enc.encode_bin(gt1, ctxs(f"GT1_{suf}", gctx))
                par = gt3 = 0
                if gt1:
                    par = (a - 2) & 1
                    enc.encode_bin(par, ctxs(f"PAR_{suf}", gctx))
                    gt3 = 1 if a > 3 else 0
                    enc.encode_bin(gt3, ctxs(f"GT3_{suf}", gctx))
                    if gt3:
                        gt3_pos.append(i)
                p1[y, x] = 1 + gt1 + par + 2 * gt3
                # `full` mirrors what the *decoder* knows at each point of
                # pass2 (pass1 value now, remainder added below) so the Rice
                # parameter derivation stays in lockstep
                full[y, x] = p1[y, x]
        # pass2: remainders (same reverse order as the reader)
        for i in gt3_pos:
            x, y = scan[i]
            a = abs(int(levels[y, x]))
            par = (a - 2) & 1
            rem = (a - 4 - par) >> 1
            _write_golomb_rice(enc, rem, _rice_param(x, y, full))
            full[y, x] += 2 * rem
        # signs
        for i in nz_pos:
            x, y = scan[i]
            enc.encode_bin_ep(1 if levels[y, x] < 0 else 0)


def read_residual(dec, ctxs, size, is_luma: bool) -> np.ndarray:
    """Decode one block of quantized levels.  size: int (square) or
    (w, h) tuple (rect)."""
    if hasattr(dec, "read_residual"):  # native packer fast path
        return dec.read_residual(ctxs, size, is_luma)
    w, h = (size, size) if isinstance(size, int) else size
    log2w = int(w).bit_length() - 1
    log2h = int(h).bit_length() - 1
    scan = full_scan_rect(log2w, log2h)
    nposs = len(scan)
    lx, ly = read_last_pos(dec, ctxs, log2w, log2h, is_luma)
    last = next(i for i, p in enumerate(scan) if p == (lx, ly))

    suf = "LUMA" if is_luma else "CHROMA"
    last_sb = last >> 4
    levels = np.zeros((h, w), dtype=np.int32)
    p1 = np.zeros((h, w), dtype=np.int32)
    full = np.zeros((h, w), dtype=np.int32)
    sb_coded = np.zeros(((nposs + 15) >> 4,), dtype=np.int32)
    sb_w, sb_h = max(1, w >> 2), max(1, h >> 2)

    for sb in range(last_sb, -1, -1):
        explicit = sb != last_sb and sb != 0
        if explicit:
            cgx, cgy = scan[sb * 16][0] >> 2, scan[sb * 16][1] >> 2
            nb = 0
            if cgx + 1 < sb_w and sb_coded[_cg_index(cgx + 1, cgy, sb_w, sb_h)]:
                nb = 1
            if cgy + 1 < sb_h and sb_coded[_cg_index(cgx, cgy + 1, sb_w, sb_h)]:
                nb = 1
            coded = dec.decode_bin(ctxs(f"SB_CODED_FLAG_{suf}", nb))
        else:
            coded = 1
        sb_coded[sb] = coded
        if not coded:
            continue

        start = last if sb == last_sb else min((sb + 1) * 16, nposs) - 1
        sig_found = False
        gt3_pos = []
        nz_pos = []
        for i in range(start, sb * 16 - 1, -1):
            x, y = scan[i]
            if i == last:
                sig = 1
            else:
                infer_dc = explicit and (i == sb * 16) and not sig_found
                if infer_dc:
                    sig = 1
                else:
                    sig = dec.decode_bin(ctxs(f"SIG_{suf}", _sig_ctx(x, y, p1, is_luma)))
            if sig:
                sig_found = True
                nz_pos.append(i)
                gctx = _gtx_ctx(x, y, p1, is_luma)
                gt1 = dec.decode_bin(ctxs(f"GT1_{suf}", gctx))
                par = gt3 = 0
                if gt1:
                    par = dec.decode_bin(ctxs(f"PAR_{suf}", gctx))
                    gt3 = dec.decode_bin(ctxs(f"GT3_{suf}", gctx))
                    if gt3:
                        gt3_pos.append(i)
                v = 1 + gt1 + par + 2 * gt3
                p1[y, x] = v
                full[y, x] = v
                levels[y, x] = v
        for i in gt3_pos:
            x, y = scan[i]
            rem = _read_golomb_rice(dec, _rice_param(x, y, full))
            levels[y, x] += 2 * rem
            full[y, x] = levels[y, x]
        for i in nz_pos:
            x, y = scan[i]
            if dec.decode_bin_ep():
                levels[y, x] = -levels[y, x]
    return levels


@lru_cache(maxsize=None)
def _cg_map(sb_w: int, sb_h: int):
    m = {}
    for i, (cx, cy) in enumerate(diag_scan(sb_w, sb_h)):
        m[(cx, cy)] = i
    return m


def _cg_index(cgx: int, cgy: int, sb_w: int, sb_h: int = None) -> int:
    if sb_h is None:
        sb_h = sb_w
    return _cg_map(sb_w, sb_h)[(cgx, cgy)]

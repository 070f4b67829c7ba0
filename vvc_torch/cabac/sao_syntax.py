"""SAO parameter CABAC syntax — writer/reader pair.

TPU-native analog of the reference's SAO syntax
(`VTM/source/Lib/EncoderLib/CABACWriter.cpp` → sao() /
sao_block_pars / sao_offset_pars; CABACReader mirror).  Coded once per CTU
before the coding tree (slice_data order, spec 7.3.11.2).

CTU-level: sao_merge_left_flag then sao_merge_up_flag (one shared ctx,
spec shape; signaled only when the neighbour CTU exists in the same
substream region) — a set flag copies ALL components' parameters from
the neighbour.  Otherwise per component: sao_type (1 ctx bin: on/off;
1 EP bin: BO/EO), then 4 offset magnitudes (TR cMax 7, EP), BO: sign per
nonzero offset + 5-bit band position; EO: 2-bit class (EO offset signs
are inferred: categories 1,2 ≥ 0, categories 3,4 ≤ 0).
"""
from __future__ import annotations

from vvc_torch.kernels.sao import SaoParams, SAO_OFF, SAO_BO, SAO_EO, MAX_SAO_OFFSET


def _write_offset_mag(enc, mag: int):
    for _ in range(mag):
        enc.encode_bin_ep(1)
    if mag < MAX_SAO_OFFSET:
        enc.encode_bin_ep(0)


def _read_offset_mag(dec) -> int:
    m = 0
    while m < MAX_SAO_OFFSET and dec.decode_bin_ep():
        m += 1
    return m


def write_sao_params(enc, ctxs, params3, left=None, up=None):
    """left/up: neighbour CTUs' params3 (None = not available for merge).
    The encoder merges when its decided params equal a neighbour's — a
    pure rate win with identical reconstruction."""
    if left is not None:
        if tuple(params3) == tuple(left):
            enc.encode_bin(1, ctxs("SAO_MERGE", 0))
            return
        enc.encode_bin(0, ctxs("SAO_MERGE", 0))
    if up is not None:
        if tuple(params3) == tuple(up):
            enc.encode_bin(1, ctxs("SAO_MERGE", 0))
            return
        enc.encode_bin(0, ctxs("SAO_MERGE", 0))
    for p in params3:
        if p.mode == SAO_OFF:
            enc.encode_bin(0, ctxs("SAO_TYPE", 0))
            continue
        enc.encode_bin(1, ctxs("SAO_TYPE", 0))
        enc.encode_bin_ep(1 if p.mode == SAO_EO else 0)
        for o in p.offsets:
            _write_offset_mag(enc, abs(o))
        if p.mode == SAO_BO:
            for o in p.offsets:
                if o != 0:
                    enc.encode_bin_ep(1 if o < 0 else 0)
            enc.encode_bins_ep(p.band_pos, 5)
        else:
            enc.encode_bins_ep(p.eo_class, 2)


def read_sao_params(dec, ctxs, left=None, up=None):
    if left is not None and dec.decode_bin(ctxs("SAO_MERGE", 0)):
        return tuple(left)
    if up is not None and dec.decode_bin(ctxs("SAO_MERGE", 0)):
        return tuple(up)
    out = []
    for _ in range(3):
        if not dec.decode_bin(ctxs("SAO_TYPE", 0)):
            out.append(SaoParams())
            continue
        mode = SAO_EO if dec.decode_bin_ep() else SAO_BO
        mags = [_read_offset_mag(dec) for _ in range(4)]
        if mode == SAO_BO:
            offs = []
            for m in mags:
                if m != 0 and dec.decode_bin_ep():
                    offs.append(-m)
                else:
                    offs.append(m)
            band_pos = dec.decode_bins_ep(5)
            out.append(SaoParams(mode, 0, band_pos, tuple(offs)))
        else:
            # EO sign inference: cats 1,2 positive; 3,4 negative
            offs = (mags[0], mags[1], -mags[2], -mags[3])
            eo_class = dec.decode_bins_ep(2)
            out.append(SaoParams(mode, eo_class, 0, offs))
    return tuple(out)

"""Adaptation Parameter Set (APS) — ALF / LMCS parameter transport.

Port of vvc/hls/aps.py: the ALF APS writer (`write_aps_alf`) that lossy
encode_sequence needs, and the parser (`parse_aps`, ALF and LMCS payloads)
that the decoder needs; the LMCS APS writer arrives with the LMCS encoder
(slice 2d).

TPU-native analog of the reference's APS handling
(`VTM/source/Lib/EncoderLib/VLCWriter.cpp` → HLSWriter::codeAPS,
DecoderLib/VLCReader.cpp → parseAPS; spec 7.3.2.5
adaptation_parameter_set_rbsp).  Filter/reshaper parameters ride their own
NAL units (PREFIX_APS) keyed by (params_type, id); the slice header only
references an id — so parameters survive slice parallelism, segment
concatenation and can be shared across pictures, like the reference's APS
pool (ParameterSetManager).

Payload field order is spec-shaped but not spec-complete [verify] (the
parser mirrors the writer exactly).
"""
from __future__ import annotations

import numpy as np

from vvc_torch.io.bitio import BitWriter, BitReader

APS_ALF = 0     # spec: ALF_APS
APS_LMCS = 1    # spec: LMCS_APS


def write_aps_alf(aps_id: int, luma, chroma, cc_cb=None,
                  cc_cr=None) -> bytes:
    """luma: (coeffs [nf,12] int, clips [nf] int, fmap [25] int) or None;
    chroma: coefficient vector or None; cc_cb/cc_cr: CC-ALF coefficient
    vectors (spec alf_cc_cb/cr_filter_signal_flag) or None."""
    bw = BitWriter()
    bw.write(APS_ALF, 3)                 # aps_params_type
    bw.write(aps_id, 5)                  # adaptation_parameter_set_id
    bw.write_flag(luma is not None)      # alf_luma_filter_signal_flag
    bw.write_flag(chroma is not None)    # alf_chroma_filter_signal_flag
    bw.write_flag(cc_cb is not None)     # alf_cc_cb_filter_signal_flag
    bw.write_flag(cc_cr is not None)     # alf_cc_cr_filter_signal_flag
    if luma is not None:
        coeffs, clips, fmap = luma
        nf = len(coeffs)
        bw.write_ue(nf - 1)
        for k in fmap:
            bw.write_ue(int(k))
        for fi in range(nf):
            for c in coeffs[fi]:
                bw.write_se(int(c))
            bw.write_ue(int(clips[fi]))
    if chroma is not None:
        bw.write_ue(len(chroma))
        for c in chroma:
            bw.write_se(int(c))
    for cc in (cc_cb, cc_cr):
        if cc is not None:
            bw.write_ue(len(cc))
            for c in cc:
                bw.write_se(int(c))
    bw.byte_align()
    return bw.get_bytes()


def parse_aps(rbsp: bytes):
    """→ (params_type, aps_id, payload).  ALF payload = (luma, chroma,
    cc_cb, cc_cr) in the writer's shapes; LMCS payload = codeword list."""
    br = BitReader(rbsp)
    t = br.read(3)
    aps_id = br.read(5)
    if t == APS_ALF:
        has_luma = br.read_flag()
        has_chroma = br.read_flag()
        has_cc_cb = br.read_flag()
        has_cc_cr = br.read_flag()
        luma = None
        if has_luma:
            nf = br.read_ue() + 1
            fmap = [br.read_ue() for _ in range(25)]
            coeffs = np.zeros((nf, 12), dtype=np.int32)
            clips = np.zeros(nf, dtype=np.int32)
            for fi in range(nf):
                for ci in range(12):
                    coeffs[fi, ci] = br.read_se()
                clips[fi] = br.read_ue()
            luma = (coeffs, clips, np.asarray(fmap, dtype=np.int32))
        chroma = None
        if has_chroma:
            n = br.read_ue()
            chroma = np.asarray([br.read_se() for _ in range(n)],
                                dtype=np.int32)
        ccs = []
        for has in (has_cc_cb, has_cc_cr):
            if has:
                n = br.read_ue()
                ccs.append(np.asarray([br.read_se() for _ in range(n)],
                                      dtype=np.int32))
            else:
                ccs.append(None)
        return t, aps_id, (luma, chroma, ccs[0], ccs[1])
    if t == APS_LMCS:
        n = br.read_ue()
        return t, aps_id, [br.read_ue() for _ in range(n)]
    raise ValueError(f"unknown aps_params_type {t}")

"""Adaptation Parameter Set (APS) — ALF parameter transport.

Port of vvc/hls/aps.py, cut to the ALF APS writer (`write_aps_alf`) that
lossy encode_sequence needs; the LMCS APS arrives with LMCS (slice 2d).

TPU-native analog of the reference's APS handling
(`VTM/source/Lib/EncoderLib/VLCWriter.cpp` → HLSWriter::codeAPS; spec
7.3.2.5 adaptation_parameter_set_rbsp).  Filter parameters ride their own
NAL units (PREFIX_APS) keyed by (params_type, id); the slice header only
references an id — so parameters survive slice parallelism, segment
concatenation and can be shared across pictures, like the reference's APS
pool (ParameterSetManager).

Payload field order is spec-shaped but not spec-complete [verify] (vvc's
parser, vvc/hls/aps.py parse_aps, mirrors the writer exactly).
"""
from __future__ import annotations

from vvc_torch.io.bitio import BitWriter

APS_ALF = 0     # spec: ALF_APS


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

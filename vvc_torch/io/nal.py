"""NAL unit framing: Annex-B start codes + emulation prevention.

TPU-native analog of the reference's NAL layers
(`VTM/source/Lib/EncoderLib/NALwrite.cpp` → writeNalUnit /
emulation prevention; DecoderLib/AnnexBread.cpp → byteStreamNALUnit;
DecoderLib/NALread.cpp → read(InputNALUnit&)).  OpenVVC counterpart:
libovvc/ovannexb.c, ovunits.c.

H.266 NAL header is 2 bytes:
  forbidden_zero_bit(1) | nuh_reserved_zero_bit(1) | nuh_layer_id(6)
  nal_unit_type(5) | nuh_temporal_id_plus1(3)
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class NalUnit:
    nal_type: int
    payload: bytes  # RBSP (emulation-free)
    layer_id: int = 0
    temporal_id: int = 0


def _header_bytes(nal: NalUnit) -> bytes:
    b0 = (0 << 7) | (0 << 6) | (nal.layer_id & 0x3F)
    b1 = ((nal.nal_type & 0x1F) << 3) | ((nal.temporal_id + 1) & 0x7)
    return bytes((b0, b1))


def rbsp_to_ebsp(rbsp: bytes) -> bytes:
    """Insert emulation_prevention_three_bytes (0x000003 escaping)."""
    out = bytearray()
    zeros = 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    # a NAL must not end in 0x00 0x00 (cabac_zero_word territory) — the
    # writer byte-aligns with a stop bit so this cannot occur for our payloads
    return bytes(out)


def ebsp_to_rbsp(ebsp: bytes) -> bytes:
    """Strip emulation_prevention_three_bytes."""
    out = bytearray()
    zeros = 0
    i = 0
    n = len(ebsp)
    while i < n:
        b = ebsp[i]
        if zeros >= 2 and b == 3 and i + 1 < n and ebsp[i + 1] <= 3:
            zeros = 0
            i += 1
            continue
        if zeros >= 2 and b == 3 and i + 1 == n:
            # trailing cabac-zero escape
            i += 1
            continue
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
        i += 1
    return bytes(out)


def write_annexb(nals: list) -> bytes:
    """Serialize NAL units with 4-byte start codes (first) / 3-byte (rest)."""
    out = bytearray()
    for i, nal in enumerate(nals):
        out += b"\x00\x00\x00\x01" if i == 0 or nal.nal_type in (14, 15, 16) else b"\x00\x00\x01"
        out += _header_bytes(nal)
        out += rbsp_to_ebsp(nal.payload)
    return bytes(out)


def read_annexb(data: bytes) -> list:
    """Split an Annex-B byte stream into NAL units (reference:
    AnnexBread.cpp → byteStreamNALUnit start-code scan)."""
    nals = []
    i = 0
    n = len(data)
    # find first start code
    starts = []
    zeros = 0
    while i < n:
        if zeros >= 2 and data[i] == 1:
            starts.append(i + 1)
            zeros = 0
        elif data[i] == 0:
            zeros += 1
        else:
            zeros = 0
        i += 1
    for k, s in enumerate(starts):
        e = (starts[k + 1] - 3) if k + 1 < len(starts) else n
        # trim trailing zeros belonging to the next 4-byte start code
        while e > s and data[e - 1] == 0 and k + 1 < len(starts):
            e -= 1
        unit = data[s:e]
        if len(unit) < 2:
            continue
        layer_id = unit[0] & 0x3F
        nal_type = (unit[1] >> 3) & 0x1F
        tid = (unit[1] & 0x7) - 1
        nals.append(NalUnit(nal_type, ebsp_to_rbsp(unit[2:]), layer_id, tid))
    return nals

"""Bitstream segment concatenator.

Port of vvc/cli/parcat.py (a copy, imports rewritten).  Analog of the
reference's Parcat
(`VTM/source/App/Parcat/parcat.cpp` — VTM's split-encode
story: IDR-delimited chunks encoded independently, concatenated; our
multi-host GOP sharding, SURVEY.md §2.7 P-6, produces exactly such
segments).  Round 1: All-Intra segments concatenate directly; duplicate
parameter sets from non-first segments are dropped; POC rewrite for
hierarchical GOPs lands with the inter stage [verify].

    python -m vvc_torch.cli.parcat seg0.266 seg1.266 ... -o out.266
"""
from __future__ import annotations

import sys

from vvc_torch.common.types import NalUnitType
from vvc_torch.io.nal import read_annexb, write_annexb


def concat(segments: list) -> bytes:
    """Concatenate segments; parameter sets repeat unless byte-identical to
    the currently active one (segments encoded with different QP/tiling
    carry different PPS content — dropping those would make later slices
    decode against the wrong parameter set)."""
    nals = []
    active = {}
    for data in segments:
        for nal in read_annexb(data):
            if nal.nal_type in (NalUnitType.SPS, NalUnitType.PPS):
                if active.get(nal.nal_type) == nal.payload:
                    continue
                active[nal.nal_type] = nal.payload
            nals.append(nal)
    return write_annexb(nals)


def main(argv=None):
    args = sys.argv[1:] if argv is None else argv
    out = "out.266"
    inputs = []
    i = 0
    while i < len(args):
        if args[i] == "-o":
            i += 1
            out = args[i]
        else:
            inputs.append(args[i])
        i += 1
    data = concat([open(p, "rb").read() for p in inputs])
    with open(out, "wb") as f:
        f.write(data)
    print(f"wrote {out} ({len(data)} bytes from {len(inputs)} segments)")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Decoder CLI.

Port of vvc/cli/vvcdec.py over vvc_torch.dec.decoder.decode_stream; it
runs on the card unless main() is given device="cpu".

Analog of the reference's DecoderApp
(`VTM/source/App/DecoderApp/decmain.cpp` + DecApp.cpp:
bitstream → YUV with decoded-picture-hash verification).  OpenVVC
counterpart: examples/dectest.c.

    python -m vvc_torch.cli.vvcdec -b out.266 -o dec.yuv
"""
from __future__ import annotations

import sys
import time

from vvc_torch.dec.decoder import decode_stream
from vvc_torch.io.yuv import YuvWriter


def main(argv=None, device=None):
    """Run the decoder on argv (default: sys.argv[1:]).  device: None =
    CUDA (raises without it), "cpu" = the host path on the CPU."""
    args = sys.argv[1:] if argv is None else argv
    bs = out = tracef = None
    i = 0
    while i < len(args):
        if args[i] == "-b":
            i += 1
            bs = args[i]
        elif args[i] == "-o":
            i += 1
            out = args[i]
        elif args[i] == "-tf":     # dtrace analog (--TraceFile)
            i += 1
            tracef = args[i]
        else:
            raise SystemExit(f"unknown option {args[i]}")
        i += 1
    if tracef:
        from vvc_torch.utils.trace import Trace, set_trace
        set_trace(Trace(open(tracef, "w"), channels={"SYNTAX"}))
    data = open(bs, "rb").read()
    t0 = time.perf_counter()
    frames, info = decode_stream(data, device=device)
    dt = time.perf_counter() - t0
    # hash status is per-picture in DECODE order (frames are output order)
    dec_pocs = info.get("decode_order_pocs", list(range(len(frames))))
    for poc, ok in zip(dec_pocs, info["hash_ok"]):
        status = "[OK]" if ok else ("[ERROR]" if ok is False else "")
        print(f"POC {poc:4d}  {status}")
    if out:
        bd = info["sps"].bit_depth if info["sps"] else 8
        with YuvWriter(out, bd) as w:
            for f in frames:
                w.write_frame(f)
    print(f"decoded {len(frames)} pictures in {dt:.3f}s "
          f"({len(frames) / max(dt, 1e-9):.3f} fps)")
    return 0


if __name__ == "__main__":
    sys.exit(main())

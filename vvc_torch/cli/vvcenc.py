"""Encoder CLI.

Port of vvc/cli/vvcenc.py over vvc_torch.enc.encoder.encode_sequence; it
runs on the card unless main() is given device="cpu".  Options that reach
a slice not yet ported (LMCSEnable, WaveFrontSynchro, RateControl with
TargetBitrate) raise the encoder's NotImplementedError.

Analog of the reference's EncoderApp
(`VTM/source/App/EncoderApp/encmain.cpp` + EncApp.cpp:
read YUV → encode → write bitstream + recon, per-picture log line,
summary).  Usage mirrors EncoderApp:

    python -m vvc_torch.cli.vvcenc -c encoder_intra_vtm.cfg -i in.yuv \
        -wdt 416 -hgt 240 -f 8 -q 32 -b out.266 -o recon.yuv
"""
from __future__ import annotations

import sys
import time

from vvc_torch.cli.cfg import parse_args, build_encoder_config
from vvc_torch.io.yuv import YuvReader, YuvWriter
from vvc_torch.enc.encoder import encode_sequence


def main(argv=None, device=None):
    """Run the encoder on argv (default: sys.argv[1:]).  device: None =
    CUDA (raises without it), "cpu" = the plain path."""
    opts = parse_args(sys.argv[1:] if argv is None else argv)
    sps, pps, io, leftover = build_encoder_config(opts)
    if leftover:
        print(f"note: {len(leftover)} options parsed but not yet consumed "
              f"(tools land per SURVEY.md §7.2): {sorted(leftover)[:8]}...")
    if io.get("trace_file"):
        from vvc_torch.utils.trace import Trace, set_trace
        set_trace(Trace(open(io["trace_file"], "w"),
                        channels={"SYNTAX", "BEST_MODE"}))
    frames = []
    with YuvReader(io["input"], sps.width, sps.height, sps.bit_depth) as r:
        for _ in range(io["skip"]):
            r.read_frame()
        while io["frames"] == 0 or len(frames) < io["frames"]:
            f = r.read_frame()
            if f is None:
                break
            frames.append(f)
    t0 = time.perf_counter()
    bitstream, recons, stats = encode_sequence(
        frames, qp=pps.init_qp, bit_depth=sps.bit_depth, mode=io["mode"],
        gop_size=io["gop_size"], intra_period=io["intra_period"],
        target_kbps=io["target_kbps"], fps=io["fps"],
        dep_quant=io["dep_quant"], mctf=io["mctf"], mtt=io["mtt"],
        isp=io["isp"],
        bdof=io["bdof"], dmvr=io["dmvr"],
        affine=io["affine"], mmvd=io["mmvd"], ciip=io["ciip"],
        gpm=io["gpm"], mrl=io["mrl"], amvr=io["amvr"], smvd=io["smvd"], bcw=io["bcw"],
        num_tile_cols=io["num_tile_cols"],
        num_tile_rows=io["num_tile_rows"], wpp=io["wpp"],
        lossless=io["lossless"], lmcs=io["lmcs"], device=device)
    dt = time.perf_counter() - t0
    with open(io["bitstream"], "wb") as f:
        f.write(bitstream)
    if io["recon"]:
        with YuvWriter(io["recon"], sps.bit_depth) as w:
            for r_ in recons:
                w.write_frame(r_)
    # per-picture log (reference: EncGOP::xCalculateAddPSNR format)
    total_bits = 0
    st_name = {0: "B", 1: "P", 2: "I"}
    for poc, s in enumerate(stats):
        total_bits += s["bits"]
        st = st_name.get(s.get("slice_type", 2), "I")
        print(f"POC {poc:4d} ( {st}-SLICE, QP {s.get('qp', pps.init_qp)} ) "
              f"{s['bits']:10d} bits "
              f"[Y {s['psnr_y']:.4f} dB  U {s['psnr_cb']:.4f} dB  "
              f"V {s['psnr_cr']:.4f} dB]")
    n = max(1, len(frames))
    kbps = total_bits * io["fps"] / n / 1000.0
    avg_y = sum(s["psnr_y"] for s in stats) / n
    print(f"SUMMARY {n} frames  {kbps:.2f} kbps  Y-PSNR {avg_y:.4f} dB  "
          f"{n / dt:.3f} fps")
    return 0


if __name__ == "__main__":
    sys.exit(main())

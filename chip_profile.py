#!/usr/bin/env python3
"""Where the port's main path spends its time on one NVIDIA GPU.

    python3 chip_profile.py [--trace profile_trace.json]
                            [--lossy [3|2b|2a] | --inter | --mtt |
                             --4b | --decode]

Encodes a main path of `chip_smoke.py` — two synthetic 1920×1080 frames at
QP 32 — after a small warm-up encode.  Without --lossy it is lossless
All-Intra through `vvc_torch.enc.encoder.encode_sequence`, three times:

  pooled-profiled  all frames in one call (the frame pool of the AI
                   pipeline, one host thread per frame) under
                   torch.profiler with CPU and CUDA activities.  The
                   device's busy time is the union of the trace's kernel,
                   memcpy and memset intervals; its idle share is
                   1 - busy / wall.  The trace is written to --trace.
  serial           each frame in a call of its own, one after another, so
                   one host thread works at a time.
  pooled           all frames in one call again, without the profiler.

One JSON line per run gives wall seconds, frames/s and the `utils.perf`
phase totals (thread-seconds).  serial against the two pooled runs says
whether the pool's threads overlap the host work; pooled against
pooled-profiled says what the profiler costs.

--lossy 3 (--lossy alone) is the slice-3 main path: lossy
`encode_sequence` with its default tool set (MTS, MIP, LFNST, CCLM,
deblocking, SAO, ALF, CC-ALF), run as above: pooled-profiled, serial and
pooled.  --lossy 2b and 2a are lossy All-Intra through
`Encoder.encode_frame`, one frame after the other, twice: profiled (the
device's busy time and idle share as above) and unprofiled; 2b has MTS,
MIP, LFNST, CCLM and deblocking on, 2a leaves LFNST and CCLM off.

--inter is the slice-4a main path of `chip_smoke.py` [12]: Random Access
`encode_sequence(mode="ra", gop_size=8)` of nine 1080p frames of the
motion clip (vvc_torch.io.synth.motion_clip) with the default tool set,
twice: profiled (the device's busy time and idle share as above) and
unprofiled.

--mtt is the slice-2c main path of `chip_smoke.py` [14]: All-Intra
`encode_sequence` of the two 1080p frames with the default tool set and
mtt, isp, mrl and dep_quant on, twice: profiled (busy time and idle share
as above) and unprofiled.

--4b is the slice-4b main path of `chip_smoke.py` [16]: Random Access
`encode_sequence(mode="ra", gop_size=16)` of 17 1080p frames of
`chip_smoke.tool_clip` with bench_ra1080's tool set but LMCS
(mtt, isp, mrl, dep_quant, affine, mctf, bdof, dmvr, mmvd, ciip, gpm,
amvr, smvd, bcw), twice: profiled (busy time and idle share as above) and
unprofiled; each run also prints the leaves chosen per slice-4b tool.

--decode is the decoder's wavefront path of `chip_smoke.py` [20]: the
slice-3 stream of the two 1080p frames (lossy `encode_sequence` with the
default tools, encoded first and not profiled) through
`vvc_torch.dec.decoder.decode_stream(wavefront=True)`, twice: profiled
(busy time, idle share and the device-time split by kernel as above) and
unprofiled; each run also prints the waves per picture.

Needs one CUDA card and exits non-zero without one, or when the trace
holds no device activity.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

W, H = 1920, 1080
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def busy_seconds(trace_path: str) -> tuple[float, int]:
    """Union of the device intervals of a chrome trace: (seconds, count)."""
    with open(trace_path) as fh:
        events = json.load(fh)["traceEvents"]
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                   for e in events
                   if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b <= end:
            continue
        busy += b - max(a, end)
        end = b
    return busy * 1e-6, len(spans)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", default="profile_trace.json")
    ap.add_argument("--lossy", nargs="?", const="3", choices=("3", "2b", "2a"),
                    help="profile a lossy All-Intra path: 3, encode_sequence "
                         "with the default tools (default); 2b or 2a, "
                         "encode_frame with slice 2b's or 2a's tools")
    ap.add_argument("--inter", action="store_true",
                    help="profile the Random Access path (9 frames, GOP 8)")
    ap.add_argument("--mtt", action="store_true",
                    help="profile the slice-2c path (MTT, ISP, MRL, "
                         "dependent quantization; 2 frames)")
    ap.add_argument("--4b", dest="s4b", action="store_true",
                    help="profile the slice-4b path (RA with bench_ra1080's "
                         "tools but LMCS)")
    ap.add_argument("--decode", action="store_true",
                    help="profile the wavefront decode of the slice-3 "
                         "stream (2 frames)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_profile: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from vvc_torch import ops, packer
    from vvc_torch.enc.encoder import Encoder, encode_sequence
    from vvc_torch.hls.ps import PPS, SPS
    from vvc_torch.io.synth import motion_clip, synth_frame
    from vvc_torch.utils import perf

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    ops.build()
    packer.lib()
    frames = [synth_frame(W, H, t) for t in range(2)]
    tools_2c = dict(mtt=True, isp=True, mrl=True, dep_quant=True)
    if args.inter:
        encode_sequence(motion_clip(5, 416, 240), qp=32, mode="ra",
                        gop_size=4)
        frames = motion_clip(9, W, H)
    if args.mtt:
        encode_sequence([synth_frame(416, 240, 0)], qp=32, **tools_2c)
    if args.s4b:
        from chip_smoke import GOP_4B, N_4B, RA1080_TOOLS, tool_frames
        encode_sequence(tool_frames(5, 416, 240), qp=32, mode="ra",
                        gop_size=4, **RA1080_TOOLS)
        frames = tool_frames(N_4B, W, H)
    if args.decode:
        from vvc_torch.dec import wavefront
        from vvc_torch.dec.decoder import decode_stream
        decode_stream(encode_sequence([synth_frame(416, 240, 0)], qp=32)[0],
                      wavefront=True)
        stream = encode_sequence(frames, qp=32)[0]
        waves = []
        inner_w = wavefront.reconstruct_leaves_wavefront

        def spy_waves(*a, **kw):
            waves.append(inner_w(*a, **kw))
            return waves[-1]
        wavefront.reconstruct_leaves_wavefront = spy_waves
    lossy = dict(deblocking=True, mts_intra=True, mip=True)
    if args.lossy == "2b":
        lossy.update(lfnst=True, cclm=True)
    per_frame = args.lossy in ("2a", "2b")
    lossless = args.lossy is None
    if per_frame:
        Encoder(SPS(width=416, height=240, **lossy), PPS(init_qp=32)
                ).encode_frame(synth_frame(416, 240, 0), 0)
        enc = Encoder(SPS(width=W, height=H, **lossy), PPS(init_qp=32))
    elif not (args.inter or args.mtt or args.s4b or args.decode):
        encode_sequence([synth_frame(416, 240, 0)], qp=32,
                        lossless=lossless)
    lossless = lossless and not (args.inter or args.mtt or args.s4b
                                 or args.decode)
    one_run = per_frame or args.inter or args.mtt or args.s4b or args.decode
    path = ("inter RA GOP8" if args.inter else
            "wavefront decode of the slice-3 stream" if args.decode else
            "AI mtt+isp+mrl+dep_quant" if args.mtt else
            f"RA GOP{GOP_4B} slice 4b" if args.s4b else
            f"lossy {args.lossy}" if args.lossy else "lossless")
    tools = {}

    def run(name, calls):
        perf.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        waves_run = []
        for fs in calls:
            if args.decode:
                waves.clear()
                decode_stream(stream, wavefront=True)
                waves_run = list(waves)
            elif per_frame:
                for poc, f in enumerate(fs):
                    enc.encode_frame(f, poc)
            elif args.inter:
                encode_sequence(fs, qp=32, mode="ra", gop_size=8)
            elif args.mtt:
                encode_sequence(fs, qp=32, **tools_2c)
            elif args.s4b:
                stats = encode_sequence(fs, qp=32, mode="ra",
                                        gop_size=GOP_4B, **RA1080_TOOLS)[2]
                tools.clear()
                for st in stats:
                    for k, v in st.get("inter_tools", {}).items():
                        tools[k] = tools.get(k, 0) + v
            else:
                encode_sequence(fs, qp=32, lossless=lossless)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return {"run": name,
                "path": path,
                "frames": len(frames),
                "size": f"{W}x{H}", "wall_s": wall,
                "frames_per_s": len(frames) / wall,
                "phases": perf.report(), "card": card,
                **({"inter_tools": dict(tools)} if args.s4b else {}),
                **({"waves_per_picture": waves_run} if args.decode else {})}

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        rec = run("serial-profiled" if per_frame or args.inter or args.s4b
                  or args.decode else "pooled-profiled", [frames])
    os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
    prof.export_chrome_trace(args.trace)
    busy, n_dev = busy_seconds(args.trace)
    if n_dev == 0:
        raise RuntimeError("chip_profile: the trace holds no device "
                           "activity; idle share not measured")
    rec.update(device_busy_s=busy, device_events=n_dev,
               device_idle_share=1.0 - busy / rec["wall_s"])
    print(json.dumps(rec), flush=True)
    top = prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=12)
    print(top, flush=True)
    if one_run:
        print(json.dumps(run("serial" if not args.mtt else "pooled",
                             [frames])), flush=True)
        return 0
    print(json.dumps(run("serial", [[f] for f in frames])), flush=True)
    print(json.dumps(run("pooled", [frames])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

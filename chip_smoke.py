#!/usr/bin/env python3
"""Smoke run of the vvc_torch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from vvc_torch/csrc with nvcc (sm_90a), holds
each kernel against its plain PyTorch version on the card, then drives the
port's five main paths at 1920×1080, QP 32 — lossless All-Intra through
`vvc_torch.enc.encoder.encode_sequence` (slice 1, one frame), lossy
All-Intra with MTS, MIP and deblocking through `Encoder.encode_frame`
(slice 2a, two frames), the same with LFNST and CCLM on (slice 2b, two
frames), lossy `encode_sequence` with its default tool set, SAO, ALF
and CC-ALF included (slice 3, two frames), and Random Access
`encode_sequence(mode="ra", gop_size=8)` with the same defaults on a
clip in global sub-pel motion (slice 4a, nine frames: I, P and seven B
pictures), lossy `encode_sequence` with the MTT lattice, ISP, MRL and
dependent quantization on top of the defaults (slice 2c, two frames), and
Random Access `encode_sequence(mode="ra", gop_size=8)` with bench_ra1080's
tool set but LMCS — the 2c tools plus affine, MCTF, BDOF, DMVR, MMVD,
CIIP, GPM, AMVR, SMVD and BCW — on a zoom, two-motion and fade clip
(slice 4b, nine frames) — then decodes through the port's decoder
`vvc_torch.dec.decoder.decode_stream`: the slice-3 stream on the
wavefront path through the decoder's kernels (slice 5), and the 4a, 2c
and 4b streams on the host path — then runs slice 6: the sharded encode
(`vvc_torch.shard.encode.encode_sequence_sharded`) over torch.distributed
ranks, the halo-consuming tile-edge deblock, the 2-process DCN encode and
the CLIs — and checks what comes out:

  1. card name and power limit (nvidia-smi);
  2. kernel build, with its seconds;
  3. each of the encoder's twenty-four kernels against its plain version
     on the card (exact equality; the quant_rate kernel's float rates, the
     filter statistics and the motion search's costs bit for bit), at the
     main paths' shapes, with CUDA-event times per 1080p frame (the SAO and
     ALF statistics on the recon of a 2b picture, after [7]; the four
     motion-search kernels per 1080p B picture with 2 refs per list, and
     me_qpel per size, 64, 32, 16 and the 8x8 children, as the median of
     7 timed runs; the three rect kernels, and the transforms and
     quant_rate at the rect and ISP shapes, per 1080p frame of the
     slice-2c path; affine_search and affine_dctif per 1080p B picture,
     reference 0 of each list at sizes 64, 32 and 16; me_block_err per
     1080p MCTF anchor, four neighbours);
  4. the 1080p search vectors, lossless, lossy (2a) and 2b, from the
     kernels against the plain path's;
  5. the lossless main path: recon equals the source in all planes, the
     stream starts with SPS and PPS, its three kernels' counts moved;
  6. the 2a lossy main path: each of its seven kernels launched the
     expected number of times, PSNR-Y and bytes in range;
  7. the 2b main path: each of the twelve kernels launched the expected
     number of times, PSNR and bytes in range, LFNST leaves and CCLM
     chroma modes counted;
  8. at 416×240, the kernel path's streams byte-equal to the plain path's,
     lossless, 2a and 2b, single-tile and with 2 tile columns;
  10. the slice-3 main path: each of the fourteen kernels launched the
     expected number of times (these counts fill the kernel table), PSNR
     and bytes in range, the NALs of each picture (ALF APS, slice, hash
     SEI), the SAO types and ALF filters used, and the stream byte-equal
     to the plain path's;
  11. bench_ai's configuration (8 × 416×240, QP 32, the defaults), single
     tile and 2 tile columns: kernel streams == plain streams, frames/s;
  12. the slice-4a main path (9 frames 1080p RA, GOP 8): each kernel but
     the three rect ones launched (these counts fill the kernel table for
     the other eighteen), the
     stream starts with SPS and PPS, the NAL and slice type of every
     picture, PSNR and bytes in range, the share of inter leaves and the
     histogram of their inter_dir, frames/s and the host phases;
  13. at 416×240 on the motion clip, the kernel path's streams byte-equal
     to the plain path's for LDP (4 frames), LDB (4) and RA GOP 8 (9);
  14. the slice-2c main path (2 frames 1080p, mtt, isp, mrl, dep_quant):
     every kernel but the motion search's launched (these counts fill the
     table for the three rect kernels), NAL types, PSNR and bytes in
     range, the leaves by kind (rect, TT mid, ISP, MRL, each present) and
     by shape, the search vector == the plain path's, frames/s, the
     search's device ms and the host phases;
  15. at 416×240 (2 frames), the slice-2c kernel streams byte-equal to
     the plain path's, single tile and 2 tile columns;
  16. the slice-4b main path (9 frames 1080p RA GOP 8 on `tool_clip`):
     every one of the encoder's twenty-four kernels launched (these
     counts fill the table for the three 4b kernels), NAL and slice types,
     PSNR and bytes
     in range, the leaves chosen per 4b tool (affine must be among them),
     MCTF run, frames/s and the host phases;
  17. at 416×240 on the tool clip, the kernel path's streams byte-equal
     to the plain path's: LDP with affine (3 frames) and RA GOP 4 with the
     ten 4b options (5 frames);
  19. the four decoder kernels (wave_ref_lines, dequant, wave_cclm,
     wave_commit) against their plain versions at every call of a
     wavefront decode of the [10] stream (exact), with CUDA-event times
     per 1080p frame over all those calls, bound (bytes over 3.35 TB/s)
     and plain time;
  20. the decoder's main path: the [10] stream through
     decode_stream(wavefront=True), counted — every hash OK, the frames
     equal to the encoder's recons and to the host path's, each decoder
     kernel launched once per group that needs it, frames/s on both
     paths, waves per picture; and 416×240 lossless and 2-tile-column
     streams, whose wavefront decode equals the plain path's;
  21. the 1080p streams of [12], [14] and [16] through the host-path
     decode_stream: every hash OK, frames equal to the encoder's recons,
     frames/s;
  22. the tile_edge_deblock kernel (slice 6) against its plain version
     on 1080p stripes of 2, 3 and 4 tiles, 8 and 10 bit, QP 22 and 37
     (exact), with CUDA-event times per 1080p frame of 4 stripes, bound
     (bytes over 3.35 TB/s) and plain time;
  23. slice 6's main path: `vvc_torch.shard.encode.encode_sequence_sharded`
     on 2 frames 1920x1080 QP 32 with 2 tile columns, at the NCCL world
     size (one rank per card) and on 2 and 4 gloo ranks of card 0: each
     stream byte-equal to the single-card encode_sequence's, every rank's
     search kernels launched, wall seconds and frames/s per world size;
  24. `deblock_tile_edges` over 1080p stripes on 4 gloo ranks and on the
     NCCL world: equal to the unsharded numpy pass over the boundary
     edges, one tile_edge_deblock launch per rank, the halo exchange's
     time per backend;
  25. DCN: `encode_multihost` with 2 spawned processes on the card against
     in-process, 4 frames 1920x1080 motion_clip, RA GOP 2: equal bytes,
     every MD5 OK through the port's decoder, each child's kernels
     launched;
  26. the CLIs: `vvc_torch.cli.vvcenc` -> `vvcdec` at 416x240, 3 frames,
     on the card: every POC [OK], decoded YUV == recon YUV;
  27. slice 7: the kernels interp_planes, phase_gather, block_dist,
     me_full and affine_gn against their plain versions at 1080p shapes
     (exact; float results bit for bit); then its path, counted: the r4
     engine as vvc's r4 MCTF ran it — `interp_luma_planes` of a 1920x1080
     motion_clip reference and `me_pred_program(cur, phase, 16, 8, 1920,
     1080, lam_m)` at QP 32 (120 x 67 blocks) —, `affine_me_batch` on the
     64x64 blocks of a 1080p tool_clip pair (4 and 6 parameters, seeds 0),
     `sse_batch` / `sad_batch` on the [N,16,16] blocks and `eval_ref` at
     size 16: shapes, every slice-7 kernel launched, each result equal to
     the plain path's, CUDA-event times per 1080p frame, bounds;
  28. `vvc_torch.shard.mesh.sharded_rdo_step` at the NCCL world size on the
     16x16 blocks of a 1080p picture: equal to its plain run, time.

Prints the kernel table as one JSON line, the card line, and as the last
line {"ok": true, "device": {...}}.  Any failure raises and exits non-zero
before the last line.  Needs one CUDA card; imports nothing of JAX or of
the JAX package `vvc`.  TF32 is switched off for matmuls and convolutions
(nothing on the path uses them; the SATD yardstick's float32 matmul and
the transforms' float64 yardstick must be exact).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

# peak rates of one H100 SXM (NVIDIA data sheet): HBM bytes/s, and the
# non-tensor-core float32 rate used as the CUDA-core operation rate
HBM_BYTES_PER_S = 3.35e12
CORE_OPS_PER_S = 67e12
# dependent float32 add latency in SM cycles: an assumption, not measured
# here (4 cycles on Volta in Jia et al., "Dissecting the NVIDIA Volta GPU
# Architecture via Microbenchmarking", 2018, taken as Hopper's).  One step
# of the ALF B100 walk's chain; the floor it gives is printed on [3]'s
# line only, never in the kernels line
FADD_CYCLES = 4
W_HD, H_HD = 1920, 1080
# the slice-4b path [16]: frames and GOP size (bench_ra1080: 17 and 16;
# cut to 9 and 8 so that the script, slice 6's phases included, stays well
# inside its time limit)
N_4B, GOP_4B = 9, 8
SIZES = (8, 16, 32, 64)
MTS_SIZES = (8, 16, 32)      # stage B (MTS) and MIP sizes
# launches per 1080p frame on the lossy main path: stage A at 4 sizes +
# stage B's 4 MTS pairs at 3 sizes; SATD once per size + once for MIP
LOSSY_LAUNCHES = {"ref_lines": 4, "intra_pred_all": 4, "satd": 7,
                  "transform_fwd": 16, "transform_inv": 16,
                  "quant_rate": 16, "mip_pred_all": 3}
# slice 2b adds, per size: stage C (one DCT2 of the winner, then for each
# LFNST index lfnst_fwd → quant_rate → lfnst_inv → transform_inv) and the
# chroma decision (per plane: ref_lines, intra_pred_one for DM and
# cclm_models for the 3 LM variants); luma_ds once per frame
LOSSY_2B_LAUNCHES = dict(LOSSY_LAUNCHES, ref_lines=12, transform_fwd=20,
                         transform_inv=24, quant_rate=24, lfnst_fwd=8,
                         lfnst_inv=8, luma_ds=1, cclm_models=24,
                         intra_pred_one=8)
LOSSLESS_KERNELS = ("ref_lines", "intra_pred_all", "satd")
# slice 3 adds the filter statistics: SAO per component, ALF once
SLICE3_LAUNCHES = dict(LOSSY_2B_LAUNCHES, sao_stats=3, alf_stats=1)
ME_KERNELS = ("me_prep", "me_coarse", "me_int", "me_qpel")
# slice 2c: the MTT lattice (vvc_torch.model.partition.shape_lattice(64,
# True)), its rectangles, the rect TT mid planes ((desc, (w, h))) and the
# three kernels only the MTT + ISP path launches
MTT_SHAPES = ((64, 64), (64, 32), (32, 64), (64, 16), (32, 32), (16, 64),
              (32, 16), (16, 32), (32, 8), (16, 16), (8, 32), (16, 8),
              (8, 16), (8, 8))
MTT_RECT = tuple(s for s in MTT_SHAPES if s[0] != s[1])
MID_RECT = ((("TH", 32), (32, 16)), (("TV", 32), (16, 32)),
            (("TV", 8), (16, 8)), (("TH", 8), (8, 16)))
RECT_KERNELS = ("ref_lines_rect", "intra_pred_all_rect",
                "intra_pred_one_rect")
# slice 4b: the kernels only its tools launch, the ten options, and
# bench_ra1080's tool set (bench.py:57-60) without LMCS (slice 2d)
KERNELS_4B = ("affine_search", "affine_dctif", "me_block_err")
TOOLS_4B = dict(affine=True, mctf=True, bdof=True, dmvr=True, mmvd=True,
                ciip=True, gpm=True, amvr=True, smvd=True, bcw=True)
RA1080_TOOLS = dict(TOOLS_4B, mtt=True, isp=True, dep_quant=True, mrl=True)
# slice 5: the kernels only the decoder's wavefront path launches, and the
# ported kernels that path reuses
KERNELS_DEC = ("wave_ref_lines", "dequant", "wave_cclm", "wave_commit")
# slice 6: the kernel only the sharded path's tile-edge deblock launches,
# and the kernels of the sharded search (every rank's must launch)
KERNELS_SHARD = ("tile_edge_deblock",)
# slice 7: the kernels only the r4 engine, the Gauss-Newton affine ME and
# sse_batch / sad_batch launch
KERNELS_R4 = ("interp_planes", "phase_gather", "block_dist", "me_full",
              "affine_gn")
SHARD_SEARCH = ("ref_lines", "intra_pred_all", "satd", "transform_fwd",
                "transform_inv", "quant_rate", "mip_pred_all", "lfnst_fwd",
                "lfnst_inv", "luma_ds", "cclm_models", "intra_pred_one")
DEC_REUSED = ("intra_pred_one", "mip_pred_all", "lfnst_inv",
              "transform_inv", "luma_ds")
# operations per sample and candidate of the affine search: the bilinear
# (6 multiplies, 3 adds, the rounding's 3 and the clip's 2), the
# difference, the 8x8 Hadamard's 6 add/subtracts and |.| + sum (2)
AFF_OPS_PER_SAMPLE = 23


def tool_clip(n: int, w: int, h: int, seed: int = 5, zoom: float = 0.035,
              step: int = 15):
    """Luma planes [h, w] of n frames on which the slice-4b tools engage,
    one quadrant each, after the warp clip of tests/test_affine.py: top left
    a zoom about the quadrant's centre (affine), top right two textures
    split by a diagonal that pan apart (GPM), bottom left a static texture
    under a non-linear fade (BCW), bottom right a smooth ramp under a
    brightness ramp (CIIP).  Test content, made from `seed`."""
    rng = np.random.default_rng(seed)
    hw, hh = w // 2, h // 2
    p = rng.integers(0, 256, (2 * hh, 2 * hw)).astype(np.float64)
    for _ in range(3):
        p = (np.roll(p, 1, 0) + p + np.roll(p, -1, 0)) / 3.0
        p = (np.roll(p, 1, 1) + p + np.roll(p, -1, 1)) / 3.0
    texa = rng.integers(60, 200, (hh + 64, hw + 64))
    texb = rng.integers(60, 200, (hh + 64, hw + 64))
    tex = rng.integers(-20, 21, (h - hh, hw))
    tex2 = rng.integers(-8, 9, (h - hh, w - hw))
    bright = (160, 130, 100, 50, 0, 40, 90, 150, 200)
    yy, xx = np.mgrid[0:hh, 0:hw]
    upper = (xx + yy) < (hw + hh) // 2
    ry, rx = np.mgrid[0:h - hh, 0:w - hw]
    frames = []
    for t in range(n):
        s = 1.0 + zoom * t
        sx = np.clip((xx - hw / 2) / s + hw, 0, 2 * hw - 1).astype(int)
        sy = np.clip((yy - hh / 2) / s + hh, 0, 2 * hh - 1).astype(int)
        y = np.zeros((h, w), np.int64)
        y[:hh, :hw] = np.rint(p[sy, sx])
        a = texa[16:16 + hh, 16 + 2 * t:16 + 2 * t + hw]
        b = texb[16 + 2 * t:16 + 2 * t + hh, 16:16 + hw]
        y[:hh, hw:] = np.where(upper, a, b)[:, :w - hw]
        y[hh:, :hw] = bright[t % len(bright)] // 2 + 40 + tex
        y[hh:, hw:] = (96 + (19.2 / (w - hw)) * rx + (6.4 / (h - hh)) * ry
                       + tex2 + step * (t % 8)).astype(np.int64)
        frames.append(np.clip(y, 0, 255).astype(np.int32))
    return frames


def tool_frames(n: int, w: int, h: int):
    """`tool_clip` as 4:2:0 frames with flat chroma."""
    from vvc_torch.io.yuv import Frame
    c = np.full((h // 2, w // 2), 128, np.int32)
    return [Frame(y, c.copy(), c.copy(), 8) for y in tool_clip(n, w, h)]


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean milliseconds per call, by CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, match: str | None = None) -> float:
    """Milliseconds of device time of one call of fn (after one call to
    warm it up), by torch.profiler: the summed durations of its kernels,
    copies and fills (only the kernels whose name holds `match`, where
    given).  For launches too small to fill the card, whose CUDA-event
    time is the host's launch rate."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "vvc_torch", "_build", f"trace-{os.getpid()}.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    os.remove(path)
    return sum(float(e.get("dur", 0)) for e in events
               if e.get("ph") == "X"
               and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
               and (match is None or match in e.get("name", ""))) * 1e-3


def bound_ms(nbytes: float, nops: float) -> tuple[float, str]:
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = nops / CORE_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def alf_walk(alf, F, t, key):
    """The (group, row) entries of B100 that the ordered walk decides
    (Σ|F·t| ≥ 2^24 from B100_GEMV_MIN_POINTS grid points on), as a [100,
    12] mask, and its longest chain: the most points of one walked group
    in one lane p mod 8."""
    if t.numel() < alf.B100_GEMV_MIN_POINTS:
        return torch.zeros((100, 12), dtype=torch.bool, device=t.device), 0
    absb = torch.zeros((100, 12), dtype=torch.int64, device=t.device)
    absb.index_add_(0, key, (F * t[None]).abs().T)
    need = absb >= (1 << 24)
    per = torch.zeros((100, 8), dtype=torch.int64, device=t.device)
    lane = torch.arange(t.numel(), device=t.device) % 8
    per.index_put_((key, lane), torch.ones_like(key), accumulate=True)
    walked = need.any(dim=1)
    return need, int(per[walked].max()) if walked.any() else 0


def ref_lines_read_bytes(h: int, w: int, xs, ys, bw: int,
                         bh: int | None = None, sector: int = 32) -> int:
    """Bytes of the int32 plane that the reference lines of BW×BH blocks
    (xs, ys) must read, counted in the card's 32-B sectors: the distinct
    sectors holding row y0-1 (2·BW+1 samples, where y0 > 0) and column
    x0-1 (2·BH samples, where x0 > 0) of each block, frame-edge clamps
    applied.  BH defaults to BW (squares)."""
    bh = bw if bh is None else bh
    xs, ys = xs.long(), ys.long()
    kh = torch.arange(2 * bh, device=xs.device)
    kw = torch.arange(2 * bw, device=xs.device)
    lx = (xs - 1).clamp(0, w - 1)
    ty = (ys - 1).clamp(0, h - 1)
    left = (ys[:, None] + kh).clamp(0, h - 1) * w + lx[:, None]
    top = ty[:, None] * w + (xs[:, None] + kw).clamp(0, w - 1)
    idx = torch.cat([left[xs > 0].reshape(-1), top[ys > 0].reshape(-1),
                     (ty * w + lx)[ys > 0]])
    return int(torch.unique(idx * 4 // sector).numel()) * sector


def cclm_models_bytes(cclm, xs, ys, cs: int, ch: int, cw: int,
                      variant: int, sector: int = 32) -> int:
    """Bytes that one cclm_models launch must move: the distinct 32-B
    sectors of the downsampled-luma and chroma planes (one layout, both
    read) that hold the model points of the blocks with a neighbour —
    neighbouring blocks share their row-above and left-column sectors —
    plus xs, ys read and α, β written (16 B per block)."""
    px, py, top_ok, left_ok = cclm._model_points(xs, ys, cs, ch, cw, variant)
    idx = (py * cw + px)[top_ok | left_ok].reshape(-1)
    sectors = int(torch.unique(idx * 4 // sector).numel())
    return 2 * sectors * sector + 16 * xs.shape[0]


def grid_xy_rect(bw: int, bh: int, w: int, h: int, dev):
    """Positions of the aligned BW×BH grid of a W×H frame (row-major)."""
    ny, nx = h // bh, w // bw
    ys = (torch.arange(ny, dtype=torch.int32, device=dev) * bh
          ).repeat_interleave(nx)
    xs = (torch.arange(nx, dtype=torch.int32, device=dev) * bw).repeat(ny)
    return xs, ys


def mid_xy(desc, w: int, h: int, dev):
    """Positions of a TT mid plane's blocks: ('TH', bw) → (bw, 16) at
    y = 8 + 32·r; ('TV', bh) → (16, bh) at x = 8 + 32·k."""
    kind, s = desc
    if kind == "TH":
        xs, ys = grid_xy_rect(s, 32, w, h, dev)
        return xs, ys + 8
    xs, ys = grid_xy_rect(32, s, w, h, dev)
    return xs + 8, ys


def isp_launches(w: int, h: int):
    """The ISP stage's launches per W×H frame: for every lattice shape
    with both sides 8..32, each direction and each sub-TU, one launch on
    [N, sh, sw] (N blocks of the shape) with the sub-TU's implicit
    transform pair → [(sw, sh, N, tr_h, tr_v, square, count)], launches
    of one shape, direction and size merged into a count."""
    from vvc_torch.kernels.isp import isp_partitions, isp_tr_types
    runs = []
    for pw, ph in MTT_SHAPES:
        if not (8 <= pw <= 32 and 8 <= ph <= 32):
            continue
        n = (h // ph) * (w // pw)
        for d in (1, 2):
            parts = isp_partitions(pw, ph, d)
            sw, sh = parts[0][2], parts[0][3]
            th, tv = isp_tr_types(sw, sh)
            runs.append((sw, sh, n, th, tv, sw == sh, len(parts)))
    return runs


def grid_xy(size: int, w: int, h: int, dev):
    ny, nx = h // size, w // size
    ys = (torch.arange(ny, dtype=torch.int32, device=dev) * size
          ).repeat_interleave(nx)
    xs = (torch.arange(nx, dtype=torch.int32, device=dev) * size).repeat(ny)
    return xs, ys


def qpel_ops(s: int) -> int:
    """Operations of one me_qpel block, the least the function needs
    whatever implements it.  A filtered sample costs its non-zero taps as
    multiply-adds, 2 operations each: 14, 16 and 14 for the phases 1, 2
    and 3 (7, 8 and 7 taps), 44 for the three.  The candidates' offsets
    in ±3 quarter-pel reach integer offsets -1 and 0 at a fractional
    phase and 0 alone at phase 0, so the filtered samples are:
    - the horizontal planes fx = 1..3 over the S+8 rows the vertical taps
      reach and S+1 columns, 44 (S+8)(S+1);
    - the vertical planes fy = 1..3 on S+1 rows, of the horizontal planes
      fx = 1..3 on S+1 columns and of the integer columns (fx = 0) on S,
      44 (3 (S+1)^2 + (S+1) S).
    Then the 49 candidates' SATD, 9 operations a sample (the difference,
    the two 8-point Hadamard passes' 3 + 3 add/subtracts, |.| and the
    sum).  Shifts (fx = 0, fy = 0), rounding and clipping are not
    counted.  The peak these are held to, 67 T/s float32, counts a
    multiply-add as 2 operations; an add counted as 1 at that peak makes
    the bound lower than the card's issue rate allows, never higher."""
    return (44 * ((s + 8) * (s + 1) + 3 * (s + 1) ** 2 + (s + 1) * s)
            + 49 * s * s * 9)


def qpel_bytes(s: int, nblk: int) -> int:
    """Bytes of one me_qpel launch: the blocks read and the predictions
    written (int32), the four int32 inputs and three outputs a block, the
    padded 1080p reference read once and the MV-bits table."""
    return (nblk * (2 * s * s + 4 + 3) * 4 + (H_HD + 32) * (W_HD + 32) * 4
            + 4096 * 4)


def median_ms(fn, repeats: int = 7, warmup: int = 2) -> float:
    """Median milliseconds of one call, each call timed alone by CUDA
    events, after `warmup` calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def me_qpel_sizes(me, qcases) -> dict:
    """me_qpel per size of a 1080p B picture: qcases maps s to the
    qpel_refine arguments of each reference; the median of 7 timed runs of
    all the references' launches (CUDA events, after 2 warm-up runs),
    and the bound over the same launches (operations over 67 T/s float32,
    or bytes over 3.35 TB/s, the larger)."""
    out = {}
    for s, calls in qcases.items():
        nblk = calls[0][1].shape[0]
        ms = median_ms(lambda: [me.qpel_refine(*a) for a in calls])
        b_ms, by = bound_ms(len(calls) * qpel_bytes(s, nblk),
                            len(calls) * nblk * qpel_ops(s))
        out[s] = {"blocks": nblk, "launches": len(calls), "ms": ms,
                  "bound_ms": b_ms, "bound_by": by}
    return out


def frames_equal(a, b) -> bool:
    return len(a) == len(b) and all(
        np.array_equal(p, q) for fa, fb in zip(a, b)
        for p, q in zip(fa.planes(), fb.planes()))


def decoder_phases(ops, stats, compare, kind, frames, bs3, recons3,
                   host_streams, encode_sequence):
    """[19]-[21]: the four decoder kernels against their plain versions at
    the shapes of the [10] stream's leaves, with their times; the wavefront
    decode of that stream (the main path), counted, and of a 416x240
    lossless and 2-tile-column stream against the plain path; the 1080p
    streams of [12], [14] and [16] through the host path.  Fills `stats`
    for the decoder kernels; returns the main path's launches."""
    import torch
    from vvc_torch.dec import wavefront
    from vvc_torch.dec.decoder import decode_stream
    from vvc_torch.io.synth import synth_frame

    t19 = time.perf_counter()
    # 19. each decoder kernel against its plain version at every call of a
    # wavefront decode of the [10] stream; the calls are kept (their small
    # inputs, and the planes they read as they end) and replayed for times
    names = ("build_ref_lines_wave", "dequant_batch", "predict_cclm_wave",
             "commit_wave")
    orig = {n: getattr(wavefront, n) for n in names}
    calls = {k: [] for k in KERNELS_DEC}
    work = {k: [0, 0] for k in KERNELS_DEC}          # bytes, operations

    def ref_lines(plane, order, xs, ys, zis, s, bd):
        got = orig["build_ref_lines_wave"](plane, order, xs, ys, zis, s, bd)
        with ops.plain():
            want = orig["build_ref_lines_wave"](plane, order, xs, ys, zis,
                                                s, bd)
        compare("wave_ref_lines", got, want)
        n = xs.shape[0]
        calls["wave_ref_lines"].append((plane, order, xs, ys, zis, s, bd))
        # per leaf: 4S+1 samples and S+1 order units read, the positions,
        # the 4S+3 line written; about 6 operations per sample
        work["wave_ref_lines"][0] += n * ((4 * s + 1) * 4 + (s + 1) * 4 + 12
                                          + (4 * s + 3) * 4)
        work["wave_ref_lines"][1] += n * 6 * (4 * s + 3)
        return got

    def dequant(lv, qp, bd):
        got = orig["dequant_batch"](lv, qp, bd)
        with ops.plain():
            want = orig["dequant_batch"](lv, qp, bd)
        compare("dequant", got, want)
        calls["dequant"].append((lv, qp, bd))
        work["dequant"][0] += lv.numel() * 8
        work["dequant"][1] += lv.numel() * 6
        return got

    ds_first = []

    def cclm(ds, chroma, order, xs, ys, zis, var, s, bd, pred):
        want = pred.clone()
        with ops.plain():
            orig["predict_cclm_wave"](ds, chroma, order, xs, ys, zis, var, s,
                                      bd, want)
        got = orig["predict_cclm_wave"](ds, chroma, order, xs, ys, zis, var,
                                        s, bd, pred)
        compare("wave_cclm", got, want)
        if not ds_first:
            ds_first.append(ds)
        calls["wave_cclm"].append((chroma, order, xs, ys, zis, var, s, bd,
                                   tuple(pred.shape)))
        m = int((var != 0).sum())
        # per CCLM leaf: its ds block read and its prediction written, the
        # model's points (4 pairs) and the leaf's position; 4 B of variant
        # for every leaf; about 4 operations per sample
        work["wave_cclm"][0] += m * (s * s * 8 + 32 + 12) + 4 * xs.shape[0]
        work["wave_cclm"][1] += m * 4 * s * s
        return got

    def commit(plane, order, pred, resi, xs, ys, zis, bdpcm, bd):
        p2, o2 = plane.clone(), order.clone()
        with ops.plain():
            orig["commit_wave"](p2, o2, pred, resi, xs, ys, zis, bdpcm, bd)
        orig["commit_wave"](plane, order, pred, resi, xs, ys, zis, bdpcm, bd)
        compare("wave_commit", plane, p2)
        compare("wave_commit", order, o2)
        calls["wave_commit"].append((plane, order, pred, resi, xs, ys, zis,
                                     bdpcm, bd))
        n, s = pred.shape[0], pred.shape[1]
        # pred and resi read, the plane's samples and the order map's units
        # written, the positions and BDPCM flags read; 3 operations a sample
        work["wave_commit"][0] += n * (s * s * 12 + max(1, s // 4) ** 2 * 4
                                       + 16)
        work["wave_commit"][1] += n * 3 * s * s
        return plane

    for n, f in zip(names, (ref_lines, dequant, cclm, commit)):
        setattr(wavefront, n, f)
    try:
        dec19, info19 = decode_stream(bs3, wavefront=True)
    finally:
        for n in names:
            setattr(wavefront, n, orig[n])
    torch.cuda.synchronize()
    check(all(info19["hash_ok"]) and frames_equal(dec19, recons3),
          "[19] the checked wavefront decode differs from the encoder")
    del dec19
    scratch = {}

    def plane_copy(t):
        key = (t.data_ptr(), tuple(t.shape))
        if key not in scratch:
            scratch[key] = t.clone()
        return scratch[key]

    def replay(k):
        if k == "wave_ref_lines":
            for c in calls[k]:
                wavefront.build_ref_lines_wave(*c)
        elif k == "dequant":
            for c in calls[k]:
                wavefront.dequant_batch(*c)
        elif k == "wave_cclm":
            for chroma, order, xs, ys, zis, var, s, bd, shp in calls[k]:
                pred = torch.zeros(shp, dtype=torch.int32, device=xs.device)
                wavefront.predict_cclm_wave(ds_first[0], chroma, order, xs,
                                            ys, zis, var, s, bd, pred)
        else:
            for plane, order, *rest in calls[k]:
                wavefront.commit_wave(plane_copy(plane), plane_copy(order),
                                      *rest)
    # the kernels' times are device time (profiler): each launch holds a
    # few leaves, so CUDA events around the replay read the host's launch
    # rate, which is printed beside them; the plain versions' thousands of
    # small operations are timed by CUDA events alone (one replay)
    nfr = len(frames)
    for k in KERNELS_DEC:
        st = stats[k]
        st["ms"] = device_ms(lambda: replay(k), f"{k}_kernel") / nfr
        check(st["ms"] > 0, f"[19] the profiler saw no {k} kernel")
        wall = cuda_ms(lambda: replay(k), iters=1, warmup=0) / nfr
        with ops.plain():
            st["plain_ms"] = cuda_ms(lambda: replay(k), iters=1,
                                     warmup=0) / nfr
        st["bytes"], st["ops"] = work[k][0] / nfr, work[k][1] / nfr
        st["bound_ms"], st["bound_by"] = bound_ms(st["bytes"], st["ops"])
        print(f"[19] {k}: exact vs plain at all {len(calls[k])} calls of a "
              f"2-frame 1080p wavefront decode; per 1080p frame (all its "
              f"launches): kernel {st['ms']:.3f} ms of device time "
              f"({wall:.3f} ms by CUDA events, launch-bound), plain "
              f"{st['plain_ms']:.3f} ms by CUDA events, bound "
              f"{st['bound_ms']:.4f} ms ({st['bound_by']}), library none",
              flush=True)
    del calls, scratch, ds_first
    print(f"[19] done in {time.perf_counter() - t19:.1f} s", flush=True)
    t20 = time.perf_counter()

    # 20. the main path: the [10] stream (2 x 1080p AI QP32, the defaults)
    # through decode_stream(wavefront=True), counted, then the host path
    groups, waves = [], []
    inner_g = wavefront._recon_group
    inner_w = wavefront.reconstruct_leaves_wavefront

    def spy_group(plane, order, g, words, qp, bd, cclm_ds=None):
        groups.append((g.lossless, bool(g.has_lev.any()),
                       g.cclm and cclm_ds is not None))
        return inner_g(plane, order, g, words, qp, bd, cclm_ds)

    def spy_waves(*a, **kw):
        waves.append(inner_w(*a, **kw))
        return waves[-1]
    wavefront._recon_group = spy_group
    wavefront.reconstruct_leaves_wavefront = spy_waves
    try:
        torch.cuda.synchronize()
        ops.reset_counts()
        t0 = time.perf_counter()
        dec20, info20 = decode_stream(bs3, wavefront=True)
        torch.cuda.synchronize()
        el_wf = time.perf_counter() - t0
        launches20 = dict(ops.COUNTS)
    finally:
        wavefront._recon_group = inner_g
        wavefront.reconstruct_leaves_wavefront = inner_w
    t0 = time.perf_counter()
    dec_h, info_h = decode_stream(bs3)
    el_host = time.perf_counter() - t0
    check(all(info20["hash_ok"]) and len(info20["hash_ok"]) == len(frames)
          and all(info_h["hash_ok"]), f"[20] hashes {info20['hash_ok']} / "
          f"{info_h['hash_ok']}")
    check(frames_equal(dec20, recons3) and frames_equal(dec20, dec_h),
          "[20] wavefront frames != the encoder's recons or the host path's")
    expected = {"wave_ref_lines": len(groups), "wave_commit": len(groups),
                "dequant": sum(not ll and lev for ll, lev, _ in groups),
                "wave_cclm": sum(c for _, _, c in groups)}
    for name in ops.COUNTS:
        if name in expected:
            check(launches20[name] == expected[name] > 0,
                  f"{name}: {launches20[name]} launches on the wavefront "
                  f"decode, expected {expected[name]}")
        else:
            check((launches20[name] > 0) == (name in DEC_REUSED),
                  f"{name}: {launches20[name]} launches on the wavefront "
                  f"decode")
    print(f"[20] wavefront decode of the [10] stream ({len(frames)} frames "
          f"1920x1080 AI QP32, {len(bs3)} bytes) on {kind}: "
          f"{el_wf:.2f} s, {len(frames) / el_wf:.4f} frames/s; host path "
          f"{el_host:.2f} s, {len(frames) / el_host:.4f} frames/s; hashes "
          f"OK, frames == encoder recons == host path; waves per picture "
          f"{waves}; groups {len(groups)}; launches {launches20}",
          flush=True)
    del dec20, dec_h
    small = [synth_frame(416, 240, t) for t in range(2)]
    for kw in ({"lossless": True}, {"num_tile_cols": 2}):
        bs, recons, _ = encode_sequence(small, qp=32, **kw)
        before = ops.COUNTS["wave_commit"]
        t0 = time.perf_counter()
        a, ia = decode_stream(bs, wavefront=True)
        el = time.perf_counter() - t0
        check(ops.COUNTS["wave_commit"] > before,
              f"[20] 416x240 {kw}: the wavefront kernels did not run")
        with ops.plain():
            b, ib = decode_stream(bs, wavefront=True)
        check(all(ia["hash_ok"]) and all(ib["hash_ok"])
              and frames_equal(a, b) and frames_equal(a, recons),
              f"[20] 416x240 {kw}: kernel decode != plain decode")
        print(f"[20] 416x240 2 frames {kw}: wavefront decode {el:.2f} s; "
              f"kernel frames == plain frames == encoder recons, hashes OK",
              flush=True)

    print(f"[20] done in {time.perf_counter() - t20:.1f} s", flush=True)
    # 21. the 1080p streams of [12], [14] and [16] through the host path
    for phase, bs, recons in host_streams:
        t0 = time.perf_counter()
        dec, info = decode_stream(bs)
        el = time.perf_counter() - t0
        check(len(info["hash_ok"]) == len(recons) and all(info["hash_ok"])
              and frames_equal(dec, recons),
              f"[21] the [{phase}] stream: hashes {info['hash_ok']} or "
              f"frames != the encoder's recons")
        print(f"[21] host-path decode of the [{phase}] stream "
              f"({len(recons)} frames 1920x1080, {len(bs)} bytes): "
              f"{el:.2f} s, {len(recons) / el:.4f} frames/s; every hash OK, "
              f"frames == encoder recons; POCs in decode order "
              f"{info['decode_order_pocs']}", flush=True)
    return launches20


def _edge_frame(rng, h: int, w: int, n_tiles: int, bit_depth: int):
    """A frame whose tile-boundary edges filter: a smooth ramp, a step at
    each tile boundary that varies by 4-row group, light noise in some
    groups."""
    s = 1 << (bit_depth - 8)
    wt = w // n_tiles
    x = np.arange(w)[None, :]
    y = np.arange(h)[:, None]
    frame = (100 * s + (x // wt) * rng.integers(0, 12, (h // 4, 1)).repeat(
        4, 0) * s + (x + y) // 16
             + (rng.random((h // 4, 1)) < 0.3).repeat(4, 0)
             * rng.integers(0, 3 * s + 1, (h, w)))
    return np.clip(frame, 0, (1 << bit_depth) - 1).astype(np.int32)


def _gather_counts():
    """Every rank's kernel launch counts, on every rank."""
    import torch.distributed as dist
    from vvc_torch import ops
    counts = [None] * dist.get_world_size()
    dist.all_gather_object(counts, dict(ops.COUNTS))
    return counts


def _sharded_encode_rank(frames, device):
    """[23]'s rank body: encode_sequence_sharded, this rank's kernel counts
    set to 0 just before it and read just after."""
    import torch.distributed as dist
    from vvc_torch import ops
    from vvc_torch.shard.encode import encode_sequence_sharded
    torch.cuda.synchronize()
    dist.barrier()
    ops.reset_counts()
    t0 = time.perf_counter()
    out = encode_sequence_sharded(frames, qp=32, num_tile_cols=2,
                                  device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _gather_counts()
    return (None if out is None else out[0]), counts, wall, \
        dist.get_backend()


def _deblock_rank(stripes, qp, bit_depth, device):
    """[24]'s rank body: the halo exchange alone, timed (mean of 20, after
    one warm-up), then deblock_tile_edges with the counts set to 0 just
    before it and read just after."""
    import torch.distributed as dist
    from vvc_torch import ops
    from vvc_torch.shard.filter import deblock_tile_edges
    from vvc_torch.shard.halo import exchange_local
    from vvc_torch.shard.mesh import make_mesh, mesh_index
    mesh = make_mesh(dist.get_world_size(), 1)
    x = torch.from_numpy(stripes).to(device)
    own = x[mesh_index(mesh, ("tile",))[0]].contiguous()
    exchange_local(mesh, own, 4)
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(20):
        exchange_local(mesh, own, 4)
    torch.cuda.synchronize()
    halo_ms = (time.perf_counter() - t0) * 1e3 / 20
    dist.barrier()
    ops.reset_counts()
    out = deblock_tile_edges(mesh, x, qp, bit_depth)
    torch.cuda.synchronize()
    counts = _gather_counts()
    halos = [None] * dist.get_world_size()
    dist.all_gather_object(halos, halo_ms)
    return out.cpu().numpy(), counts, halos, dist.get_backend()


def shard_phases(ops, stats, compare, kind, encode_sequence):
    """[22]-[26]: the tile_edge_deblock kernel against its plain version on
    1080p stripes; the sharded encode (slice 6's main path) at the NCCL
    world size and on 2 and 4 gloo ranks of one card; the halo-consuming
    tile-edge deblock; the 2-process DCN encode; the CLI round trip.
    Returns the tile_edge_deblock launches of [24]'s 4-rank run."""
    import contextlib
    import io
    import tempfile
    from vvc_torch.cli import vvcdec, vvcenc
    from vvc_torch.dec.decoder import decode_stream
    from vvc_torch.io.synth import motion_clip, synth_frame
    from vvc_torch.io.yuv import YuvWriter
    from vvc_torch.kernels.deblock import BETA_TABLE, _filter_luma_edges_v
    from vvc_torch.shard.dcn import encode_multihost
    from vvc_torch.shard.filter import deblock_stripe, edge_params
    from vvc_torch.shard.launch import run_ranks
    from vvc_torch.shard.mesh import backend_for

    dev = torch.device("cuda")
    n_cards = torch.cuda.device_count()
    rng = np.random.default_rng(22)

    # 22. tile_edge_deblock against its plain version on 1080p stripes;
    # timed per 1080p frame at [24]'s shapes (4 stripes of 480, QP 32,
    # 8 bit: one call per stripe)
    t22 = time.perf_counter()
    n_cmp = 0
    for n_tiles in (2, 3, 4):
        wt = W_HD // n_tiles
        for bd in (8, 10):
            frame = torch.from_numpy(_edge_frame(rng, H_HD, W_HD, n_tiles,
                                                 bd)).to(dev)
            zeros = torch.zeros((H_HD, 4), dtype=torch.int32, device=dev)
            for qp in (22, 32, 37):
                if n_tiles < 4 and qp == 32 or n_tiles == 4 and qp != 32:
                    continue
                beta, tc, maxv = edge_params(qp, bd)
                for i in range(n_tiles):
                    x = frame[:, i * wt:(i + 1) * wt].contiguous()
                    fl = (frame[:, i * wt - 4:i * wt].contiguous() if i
                          else zeros)
                    fr = (frame[:, (i + 1) * wt:(i + 1) * wt + 4]
                          .contiguous() if i < n_tiles - 1 else zeros)
                    args = (x, fl, fr, i > 0, i < n_tiles - 1, beta, tc,
                            maxv)
                    got = deblock_stripe(*args)
                    with ops.plain():
                        want = deblock_stripe(*args)
                    compare("tile_edge_deblock", got, want)
                    check(bool((got != x).any()) == (tc > 0 and n_tiles > 1),
                          "[22] tile_edge_deblock changed nothing")
                    n_cmp += 1
                    if n_tiles != 4 or bd != 8:
                        continue
                    st = stats["tile_edge_deblock"]
                    k_ms = cuda_ms(lambda: deblock_stripe(*args), iters=50)
                    with ops.plain():
                        p_ms = cuda_ms(lambda: deblock_stripe(*args))
                    edges = int(i > 0) + int(i < n_tiles - 1)
                    # the stripe and both halos read, the filtered stripe
                    # written; about 40 integer operations per sample of
                    # each edge's 8-column window
                    add_bytes = (2 * H_HD * wt + 2 * H_HD * 4) * 4
                    st["ms"] += k_ms
                    st["plain_ms"] += p_ms
                    st["bytes"] += add_bytes
                    st["ops"] += edges * H_HD * 8 * 40
    st = stats["tile_edge_deblock"]
    st["bound_ms"], st["bound_by"] = bound_ms(st["bytes"], st["ops"])
    print(f"[22] tile_edge_deblock: exact vs plain at {n_cmp} calls (1080p "
          f"stripes of 2, 3 and 4 tiles; 8 and 10 bit; QP 22 and 37, and "
          f"32 at 4 tiles); per 1080p frame of 4 stripes at QP 32, 8 bit: "
          f"kernel {st['ms']:.4f} ms, plain {st['plain_ms']:.4f} ms, bound "
          f"{st['bound_ms']:.4f} ms ({st['bound_by']}), library none; "
          f"{time.perf_counter() - t22:.1f} s", flush=True)

    # 23. the slice's main path: encode_sequence_sharded on 2 frames
    # 1920x1080 QP 32 with 2 tile columns, at the NCCL world size (one
    # rank per card) and on 2 and 4 gloo ranks of card 0, each against
    # the single-card encode_sequence
    t23 = time.perf_counter()
    frames = [synth_frame(W_HD, H_HD, t) for t in range(2)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bs_ref = encode_sequence(frames, qp=32, num_tile_cols=2)[0]
    torch.cuda.synchronize()
    el_ref = time.perf_counter() - t0
    print(f"[23] single-card encode_sequence(num_tile_cols=2), 2 frames "
          f"1920x1080 QP32 on {kind}: {len(bs_ref)} bytes, {el_ref:.2f} s, "
          f"{len(frames) / el_ref:.4f} frames/s", flush=True)
    for world, backend in ((n_cards, backend_for(n_cards, None)),
                           (2, "gloo"), (4, "gloo")):
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        bs, counts, wall, used = run_ranks(_sharded_encode_rank, world,
                                           backend, "cuda", 600, frames)
        total = time.perf_counter() - t0
        check(used == backend, f"[23] backend {used}, asked {backend}")
        check(bs == bs_ref, f"[23] sharded stream at {world} ranks "
              f"({backend}) != the single-card stream")
        for r, c in enumerate(counts):
            check(all(c[k] > 0 for k in SHARD_SEARCH),
                  f"[23] rank {r} of {world}: a search kernel did not run: "
                  f"{c}")
        print(f"[23] encode_sequence_sharded, {world} rank(s) on "
              f"{backend} ({'one card each' if backend == 'nccl' else 'card 0, host-staged collectives'}): "
              f"{len(bs)} bytes == single-card stream; {wall:.2f} s in the "
              f"ranks, {len(frames) / wall:.4f} frames/s "
              f"({total:.2f} s with spawn and set-up); search launches "
              f"per rank {[sum(c[k] for k in SHARD_SEARCH) for c in counts]}",
              flush=True)
    print(f"[23] done in {time.perf_counter() - t23:.1f} s", flush=True)

    # 24. the halo-consuming deblock: deblock_tile_edges over 1080p
    # stripes on 4 gloo ranks of card 0 and on the NCCL world, against
    # the unsharded numpy pass over the boundary edges
    t24 = time.perf_counter()
    launches24 = None
    for world, backend in ((4, "gloo"),
                           (n_cards, backend_for(n_cards, None))):
        frame = _edge_frame(rng, H_HD, W_HD, world, 8)
        wt = W_HD // world
        stripes = np.stack([frame[:, i * wt:(i + 1) * wt]
                            for i in range(world)])
        out, counts, halos, used = run_ranks(_deblock_rank, world, backend,
                                             "cuda", 300, stripes, 32, 8)
        check(used == backend, f"[24] backend {used}, asked {backend}")
        ref = frame.copy()
        ev = np.zeros((H_HD, W_HD // 8 - 1), dtype=bool)
        for i in range(1, world):
            ev[:, i * wt // 8 - 1] = True
        _filter_luma_edges_v(ref, ev, 8, int(BETA_TABLE[32]), (32, 8), 255)
        check(np.array_equal(np.concatenate(list(out), axis=1), ref),
              f"[24] sharded tile-edge deblock on {world} ranks != the "
              f"unsharded pass")
        check(all(c["tile_edge_deblock"] == 1 for c in counts),
              f"[24] tile_edge_deblock launches per rank "
              f"{[c['tile_edge_deblock'] for c in counts]}")
        if launches24 is None:
            launches24 = sum(c["tile_edge_deblock"] for c in counts)
        print(f"[24] deblock_tile_edges over 1080p stripes, {world} rank(s) "
              f"on {backend}: == the unsharded pass over the {world - 1} "
              f"boundary edge(s) ({int((ref != frame).sum())} samples "
              f"changed); one tile_edge_deblock launch per rank; halo "
              f"exchange (4 columns each way) ms per rank "
              f"{[round(h, 4) for h in halos]}", flush=True)
    print(f"[24] done in {time.perf_counter() - t24:.1f} s", flush=True)

    # 25. DCN: encode_multihost with 2 spawned processes on the card
    # against in-process, 4 frames 1920x1080 motion_clip, RA, GOP 2
    t25 = time.perf_counter()
    clip = motion_clip(4, W_HD, H_HD)
    kw = dict(n_hosts=2, gop_size=2, qp=32, mode="ra", return_counts=True)
    t0 = time.perf_counter()
    bs_mp, rec_mp, _, counts_mp = encode_multihost(clip, processes=True,
                                                   timeout_s=900, **kw)
    el_mp = time.perf_counter() - t0
    t0 = time.perf_counter()
    bs_ip, _, _, counts_ip = encode_multihost(clip, processes=False, **kw)
    el_ip = time.perf_counter() - t0
    check(bs_mp == bs_ip, "[25] 2-process DCN stream != in-process stream")
    for i, c in enumerate(counts_mp):
        check(all(c[k] > 0 for k in SHARD_SEARCH + ME_KERNELS),
              f"[25] child {i}: a kernel did not run: {c}")
    dec, info = decode_stream(bs_mp)
    check(len(info["hash_ok"]) == len(clip) and all(info["hash_ok"])
          and frames_equal(dec, rec_mp),
          f"[25] DCN stream: hashes {info['hash_ok']} or frames != recons")
    print(f"[25] encode_multihost 4 frames 1920x1080 RA GOP2 QP32, 2 "
          f"segments: 2 processes {el_mp:.2f} s ({len(clip) / el_mp:.4f} "
          f"frames/s with spawn), in-process {el_ip:.2f} s "
          f"({len(clip) / el_ip:.4f} frames/s); {len(bs_mp)} bytes, equal; "
          f"decodes with every MD5 OK, POCs {info['decode_order_pocs']}; "
          f"search + ME launches per child "
          f"{[sum(c[k] for k in SHARD_SEARCH + ME_KERNELS) for c in counts_mp]}"
          f" (in-process {[sum(c.values()) for c in counts_ip]}); "
          f"{time.perf_counter() - t25:.1f} s", flush=True)

    # 26. the CLIs: vvcenc -> vvcdec at 416x240, 3 frames, on the card
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "in.yuv")
        with YuvWriter(src) as wr:
            for t in range(3):
                wr.write_frame(synth_frame(416, 240, t))
        paths = {k: os.path.join(tmp, k) for k in ("out.266", "rec.yuv",
                                                   "dec.yuv")}
        log = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            rc_e = vvcenc.main(["-i", src, "-wdt", "416", "-hgt", "240",
                                "-f", "3", "-q", "32", "-b",
                                paths["out.266"], "-o", paths["rec.yuv"]])
            rc_d = vvcdec.main(["-b", paths["out.266"], "-o",
                                paths["dec.yuv"]])
        el = time.perf_counter() - t0
        lines = log.getvalue().splitlines()
        poc_ok = [ln for ln in lines if ln.startswith("POC") and "[OK]" in ln]
        with open(paths["rec.yuv"], "rb") as fa, \
                open(paths["dec.yuv"], "rb") as fb:
            same = fa.read() == fb.read()
        check(rc_e == rc_d == 0 and len(poc_ok) == 3 and same
              and not any("[ERROR]" in ln for ln in lines),
              f"[26] CLI round trip: {lines}")
        print(f"[26] vvcenc -> vvcdec 3 frames 416x240 QP32 on {kind}: "
              f"{os.path.getsize(paths['out.266'])} bytes; every POC [OK]; "
              f"decoded YUV == recon YUV; {el:.2f} s; "
              f"{[ln for ln in lines if ln.startswith('SUMMARY')]}",
              flush=True)
    return launches24


def _rdo_step_rank(orig, refs, size, qp, device):
    """[28]'s rank body: sharded_rdo_step on a 'tile' mesh of every rank,
    the counts set to 0 just before the kernel run and read just after,
    timed (CUDA-synchronised wall, mean of 5 after one warm-up), then the
    plain run."""
    import torch.distributed as dist
    from vvc_torch import ops
    from vvc_torch.shard.mesh import make_mesh, sharded_rdo_step
    mesh = make_mesh(dist.get_world_size(), 1)
    o = torch.from_numpy(orig).to(device)
    r = torch.from_numpy(refs).to(device)
    sharded_rdo_step(mesh, o, r, size, qp)
    torch.cuda.synchronize()
    dist.barrier()
    ops.reset_counts()
    got = sharded_rdo_step(mesh, o, r, size, qp)
    torch.cuda.synchronize()
    counts = dict(ops.COUNTS)
    t0 = time.perf_counter()
    for _ in range(5):
        sharded_rdo_step(mesh, o, r, size, qp)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / 5
    with ops.plain():
        t0 = time.perf_counter()
        want = sharded_rdo_step(mesh, o, r, size, qp)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
    same = (torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
            and torch.equal(got[1], want[1])
            and torch.equal(got[2], want[2]))
    return same, counts, ms, plain_ms, got[0].shape[0], float(got[2])


def r4_phases(ops, stats, compare, kind):
    """[27]-[28]: slice 7's kernels against their plain versions at 1080p
    shapes; its path, counted (the r4 engine at 1920x1080, the Gauss-Newton
    affine ME, SSE/SAD, eval_ref); times and bounds; sharded_rdo_step at the
    NCCL world size.  Returns the launches of the counted run."""
    import torch.nn.functional as F
    from vvc_torch.enc import inter_search, me, rdo
    from vvc_torch.io.synth import motion_clip, synth_frame
    from vvc_torch.kernels import affine, mc, satd
    from vvc_torch.shard.launch import run_ranks
    from vvc_torch.shard.mesh import backend_for

    dev = torch.device("cuda")
    t27 = time.perf_counter()
    rng = np.random.default_rng(27)
    S, R, QP = 16, 8, 32
    lam = np.float32(np.sqrt(0.57 * 2 ** ((QP - 12) / 3)))
    clip = motion_clip(2, W_HD, H_HD)
    cur = torch.from_numpy(clip[1].y.astype(np.int32)).to(dev)
    refp = torch.from_numpy(clip[0].y.astype(np.int32)).to(dev)
    tc = tool_clip(2, W_HD, H_HD)
    a_cur = torch.from_numpy(tc[1].astype(np.float32)).to(dev)
    a_ref = torch.from_numpy(tc[0].astype(np.float32)).to(dev)
    ny, nx = H_HD // S, W_HD // S
    n = ny * nx
    xs, ys = grid_xy(S, W_HD, H_HD, dev)
    blocks = me.raster_blocks(cur, ny, nx, S)
    zero = torch.zeros(n, dtype=torch.int32, device=dev)
    ax_, ay_ = grid_xy(64, W_HD, H_HD, dev)
    a_blocks = me.raster_blocks(a_cur, H_HD // 64, W_HD // 64, 64)
    a_zero = torch.zeros(ax_.shape[0], dtype=torch.int32, device=dev)

    def bits_equal(name, got, want):
        compare(name, got.view(torch.int32) if got.is_floating_point()
                else got, want.view(torch.int32) if want.is_floating_point()
                else want)

    # each kernel against its plain version (8 and 10 bit where it reads
    # samples), at the shapes of the path
    for bd in (8, 10):
        plane = (refp if bd == 8 else torch.from_numpy(rng.integers(
            0, 1 << bd, (H_HD, W_HD)).astype(np.int32)).to(dev))
        got = mc.interp_luma_planes(plane, bd)
        with ops.plain():
            want = mc.interp_luma_planes(plane, bd)
        compare("interp_planes", got, want)
        ob = (blocks if bd == 8 else me.raster_blocks(torch.from_numpy(
            rng.integers(0, 1 << bd, (H_HD, W_HD)).astype(np.int32)).to(dev),
            ny, nx, S))
        cx0 = torch.from_numpy(rng.integers(-12, 13, n).astype(
            np.int32)).to(dev)
        cy0 = torch.from_numpy(rng.integers(-12, 13, n).astype(
            np.int32)).to(dev)
        for c0 in ((zero, zero), (cx0, cy0)):
            args = (ob, plane, xs, ys, S, R, lam) + c0
            got = inter_search.int_me(*args)
            with ops.plain():
                want = inter_search.int_me(*args)
            for g, w_ in zip(got, want):
                compare("me_full", g, w_)
        mvx = torch.from_numpy(rng.integers(-200, 200, n).astype(
            np.int32)).to(dev)
        mvy = torch.from_numpy(rng.integers(-200, 200, n).astype(
            np.int32)).to(dev)
        args = (mc.interp_luma_planes(plane, bd), xs, ys, mvx, mvy, S)
        pred = mc.gather_pred_planes(*args)
        with ops.plain():
            compare("phase_gather", pred, mc.gather_pred_planes(*args))
        for fn in (satd.sse_batch, satd.sad_batch):
            got = fn(pred, ob)
            with ops.plain():
                want = fn(pred, ob)
            bits_equal("block_dist", got, want)
        del args
    for npar in (4, 6):
        args = (a_blocks, a_ref, ax_, ay_, a_zero, a_zero, 64, 8, npar)
        got = affine.affine_me_batch(*args)
        with ops.plain():
            want = affine.affine_me_batch(*args)
        compare("affine_gn", got, want)
    torch.cuda.synchronize()
    print(f"[27] interp_planes, phase_gather, block_dist, me_full and "
          f"affine_gn == plain at 1080p shapes (8 and 10 bit; N = {n} "
          f"16x16 blocks, {ax_.shape[0]} 64x64 affine blocks); "
          f"{time.perf_counter() - t27:.1f} s", flush=True)

    # the path, counted
    def path():
        phase = mc.interp_luma_planes(refp, 8)
        plane, err = inter_search.me_pred_program(cur, phase, S, R, W_HD,
                                                  H_HD, lam)
        cps = [affine.affine_me_batch(a_blocks, a_ref, ax_, ay_, a_zero,
                                      a_zero, 64, 8, npar)
               for npar in (4, 6)]
        pblocks = me.raster_blocks(plane, ny, nx, S)
        sse, sad = satd.sse_batch(pblocks, blocks), satd.sad_batch(pblocks,
                                                                   blocks)
        pp, _ = me.prep_ref(refp)
        ev = me.eval_ref(pp, blocks, ys, xs, zero, zero, lam, S, H_HD, W_HD,
                         8)
        return plane, err, cps, sse, sad, ev

    path()
    torch.cuda.synchronize()
    ops.reset_counts()
    t0 = time.perf_counter()
    plane, err, cps, sse, sad, ev = path()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.COUNTS)
    for k in KERNELS_R4 + ("satd", "me_prep", "me_int", "me_qpel"):
        check(launches[k] > 0, f"[27] {k} did not run on slice 7's path: "
              f"{launches}")
    check(tuple(plane.shape) == (ny * S, nx * S)
          and tuple(err.shape) == (ny, nx) and bool(torch.isfinite(err).all())
          and bool((err >= 0).all()), f"[27] plane {tuple(plane.shape)}, "
          f"err {tuple(err.shape)}")
    check(all(tuple(c.shape) == (ax_.shape[0], 3, 2) for c in cps)
          and tuple(sse.shape) == tuple(sad.shape) == (n,)
          and tuple(ev["pred"].shape) == (n, S, S), "[27] output shapes")
    with ops.plain():
        want = path()
    compare("phase_gather", plane, want[0])       # the r4 plane
    bits_equal("block_dist", err, want[1])
    for g, w_ in zip(cps, want[2]):
        compare("affine_gn", g, w_)
    bits_equal("block_dist", sse, want[3])
    compare("block_dist", sad, want[4])
    for k in ("mvy", "mvx", "cost", "pred"):
        bits_equal("me_int", ev[k], want[5][k])
    err_mean = float(err.mean())
    # prediction quality: the r4 plane against the picture it predicts
    psnr = 10 * np.log10(255.0 ** 2 / max(err_mean, 1e-9))
    check(psnr > 25.0, f"[27] r4 prediction PSNR {psnr:.2f} dB")
    print(f"[27] slice 7's path on {kind}: interp_luma_planes + "
          f"me_pred_program at 1920x1080 (S {S}, R {R}, QP {QP}, "
          f"{nx}x{ny} blocks), affine_me_batch 4 and 6 parameters on "
          f"{ax_.shape[0]} 64x64 blocks, sse/sad_batch on {n} 16x16 blocks, "
          f"eval_ref at 16: {wall * 1e3:.3f} ms, == plain; plane "
          f"{tuple(plane.shape)}, mean err {err_mean:.4f} "
          f"({psnr:.2f} dB), integer MVs != 0 in "
          f"{int((ev['iy'] != 0).sum() + (ev['ix'] != 0).sum())} of "
          f"{2 * n} eval_ref components; launches "
          f"{ {k: launches[k] for k in KERNELS_R4 + ('satd', 'me_int', 'me_qpel')} }",
          flush=True)

    # times per 1080p frame (one call of each at the path's shapes)
    phase = mc.interp_luma_planes(refp, 8)
    hw = H_HD * W_HD
    st = stats["interp_planes"]
    st["ms"] = cuda_ms(lambda: mc.interp_luma_planes(refp, 8), iters=20)
    with ops.plain():
        st["plain_ms"] = cuda_ms(lambda: mc.interp_luma_planes(refp, 8),
                                 iters=3)
    st["bytes"], st["ops"] = 17 * hw * 4, hw * 2 * (4 * 8 * 8 + 16 * 8)
    taps = torch.from_numpy(np.einsum(
        "yk,xl->yxkl", mc.LUMA_FILTERS, mc.LUMA_FILTERS).reshape(
            16, 1, 8, 8).astype(np.float64)).to(dev)
    padded = F.pad(refp.double()[None, None], (3, 4, 3, 4),
                   mode="replicate")
    st["library_ms"] = cuda_ms(lambda: F.conv2d(padded, taps), iters=5)
    # phase_gather: 18 calls of N x 16 x 16 per frame (start, 8 half-pel,
    # 8 quarter-pel candidates, the winner's prediction)
    fx, fy, _ = inter_search.frac_refine(blocks, phase, xs, ys, zero, zero,
                                         S, lam)
    st = stats["phase_gather"]
    g = lambda: mc.gather_pred_planes(phase, xs, ys, fx, fy, S)
    st["ms"] = 18 * cuda_ms(g, iters=20)
    with ops.plain():
        st["plain_ms"] = 18 * cuda_ms(g, iters=5)
    st["bytes"], st["ops"] = 18 * (2 * n * S * S * 4 + 4 * n * 4), 0
    mvx64, mvy64 = fx.long(), fy.long()
    o = torch.arange(S, device=dev)
    iy = (ys.long()[:, None] + (mvy64 >> 2)[:, None] + o).clamp(0, H_HD - 1)
    ix = (xs.long()[:, None] + (mvx64 >> 2)[:, None] + o).clamp(0, W_HD - 1)
    pf, px = (mvy64 & 3)[:, None, None], (mvx64 & 3)[:, None, None]
    st["library_ms"] = 18 * cuda_ms(
        lambda: phase[pf, px, iy[:, :, None], ix[:, None, :]], iters=10)
    # block_dist: the err SSE and the path's sse_batch + sad_batch (two
    # SSE calls and one SAD call per frame)
    pred = mc.gather_pred_planes(phase, xs, ys, fx, fy, S)
    st = stats["block_dist"]
    sse_ms = cuda_ms(lambda: satd.sse_batch(pred, blocks), iters=20)
    sad_ms = cuda_ms(lambda: satd.sad_batch(pred, blocks), iters=20)
    with ops.plain():
        sse_plain_ms = cuda_ms(lambda: satd.sse_batch(pred, blocks), iters=3)
        sad_plain_ms = cuda_ms(lambda: satd.sad_batch(pred, blocks), iters=3)
    st["ms"] = 2 * sse_ms + sad_ms
    st["plain_ms"] = 2 * sse_plain_ms + sad_plain_ms
    st["bytes"], st["ops"] = 3 * (2 * n * S * S * 4 + n * 4), 3 * n * S * S * 3
    # me_full: one call per frame
    st = stats["me_full"]
    fm = lambda: inter_search.int_me(blocks, phase[0, 0], xs, ys, S, R, lam,
                                     zero, zero)
    st["ms"] = cuda_ms(fm, iters=5)
    with ops.plain():
        st["plain_ms"] = cuda_ms(fm, iters=1, warmup=1)
    st["bytes"] = n * S * S * 4 + hw * 4 + 4 * n * 4 + 2 * n * 4
    st["ops"] = n * (2 * R + 1) ** 2 * S * S * 2
    # affine_gn: 4 and 6 parameters on the frame's 64x64 blocks
    st = stats["affine_gn"]
    na = ax_.shape[0]
    for npar, per in ((4, 60), (6, 90)):
        fa = lambda: affine.affine_me_batch(a_blocks, a_ref, ax_, ay_,
                                            a_zero, a_zero, 64, 8, npar)
        st["ms"] += cuda_ms(fa, iters=5)
        with ops.plain():
            st["plain_ms"] += cuda_ms(fa, iters=1, warmup=1)
        st["bytes"] += na * 64 * 64 * 4 + hw * 4 + 4 * na * 4 + na * 24
        st["ops"] += na * 64 * 64 * 4 * per
    for k in KERNELS_R4:
        st = stats[k]
        st["bound_ms"], st["bound_by"] = bound_ms(st["bytes"], st["ops"])
    fr = lambda: inter_search.frac_refine(blocks, phase, xs, ys, zero, zero,
                                          S, lam)
    frac_ms = cuda_ms(fr, iters=5)
    pp = me.prep_ref(refp)[0]
    ev = lambda: me.eval_ref(pp, blocks, ys, xs, zero, zero, lam, S, H_HD,
                             W_HD, 8)
    ev_ms = cuda_ms(ev, iters=5)
    with ops.plain():
        frac_plain_ms = cuda_ms(fr, iters=1, warmup=1)
        ev_plain_ms = cuda_ms(ev, iters=1, warmup=1)
    path_ms = cuda_ms(lambda: inter_search.me_pred_program(
        cur, mc.interp_luma_planes(refp, 8), S, R, W_HD, H_HD, lam), iters=5)
    with ops.plain():
        path_plain_ms = cuda_ms(lambda: inter_search.me_pred_program(
            cur, mc.interp_luma_planes(refp, 8), S, R, W_HD, H_HD, lam),
            iters=1, warmup=1)
    print(f"[27] per 1080p frame on {kind} (CUDA events): "
          + "; ".join(f"{k} {stats[k]['ms']:.4f} ms (plain "
                      f"{stats[k]['plain_ms']:.4f}, bound "
                      f"{stats[k]['bound_ms']:.4f} {stats[k]['bound_by']}, "
                      f"library {stats[k]['library_ms']})"
                      for k in KERNELS_R4)
          + f"; sse_batch {sse_ms:.4f} ms (plain {sse_plain_ms:.4f}); "
          f"sad_batch {sad_ms:.4f} ms (plain {sad_plain_ms:.4f}); "
          f"frac_refine {frac_ms:.4f} ms (plain {frac_plain_ms:.4f}); "
          f"interp_luma_planes + me_pred_program {path_ms:.4f} ms (plain "
          f"{path_plain_ms:.4f}); eval_ref at 16 {ev_ms:.4f} ms (plain "
          f"{ev_plain_ms:.4f}); {time.perf_counter() - t27:.1f} s",
          flush=True)

    # 28. sharded_rdo_step at the NCCL world size on a 1080p picture's
    # 16x16 blocks
    t28 = time.perf_counter()
    n_cards = torch.cuda.device_count()
    f0 = synth_frame(W_HD, H_HD, 0)
    y0 = torch.from_numpy(f0.y.astype(np.int32)).to(dev)
    refs = rdo.build_ref_lines_device(y0, xs, ys, S, 8)
    orig = me.raster_blocks(y0, ny, nx, S)
    same, counts, ms, plain_ms, nb, total = run_ranks(
        _rdo_step_rank, n_cards, backend_for(n_cards, None), "cuda", 600,
        orig.cpu().numpy(), refs.cpu().numpy(), S, QP)
    check(same and nb == n, f"[28] sharded_rdo_step: kernels != plain "
          f"({nb} blocks)")
    check(all(counts[k] > 0 for k in ("intra_pred_all", "satd",
                                      "transform_fwd", "quant_rate")),
          f"[28] sharded_rdo_step's kernels did not run: {counts}")
    print(f"[28] sharded_rdo_step on {n_cards} rank(s) "
          f"({backend_for(n_cards, None)}), {n} 16x16 blocks of a 1080p "
          f"picture, QP {QP}: == plain; {ms:.4f} ms a step (plain "
          f"{plain_ms:.4f} ms); total cost {total:.1f}; launches "
          f"{ {k: v for k, v in counts.items() if v} }; "
          f"{time.perf_counter() - t28:.1f} s", flush=True)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from vvc_torch import ops
    from vvc_torch import packer
    from vvc_torch.enc import me, rdo
    from vvc_torch.enc.encoder import Encoder, encode_sequence
    from vvc_torch.hls.ps import PPS, SPS
    from vvc_torch.io.nal import read_annexb
    from vvc_torch.io.synth import motion_clip, synth_frame
    from vvc_torch.enc import sao_enc
    from vvc_torch.kernels import (alf, cclm, intra, lfnst, mip, quant, sao,
                                   satd, transform)
    from vvc_torch.kernels.mc import LUMA_FILTERS
    from vvc_torch.packer import native_recon
    from vvc_torch.utils import perf

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    card = smi[0].strip()
    kind = torch.cuda.get_device_name(0)
    t_start = time.perf_counter()
    print(f"[1] card: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {kind}", flush=True)

    # 2. build the kernels (one nvcc per source, in parallel) + CABAC core
    t0 = time.perf_counter()
    build_s = ops.build(verbose=True)
    t1 = time.perf_counter()
    packer.lib()
    t2 = time.perf_counter()
    native_recon.available()
    print(f"[2] kernels built in {build_s:.1f} s; CABAC core "
          f"{t2 - t1:.1f} s; recon core {time.perf_counter() - t2:.1f} s; "
          f"total {time.perf_counter() - t0:.1f} s", flush=True)

    rng = np.random.default_rng(2026)
    stats = {k: {"max_abs_err": 0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                 "bytes": 0.0, "ops": 0.0, "library_ms": None}
             for k in ops.COUNTS}

    def compare(name, got, want):
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], err)
        check(got.shape == want.shape and err == 0,
              f"{name}: kernel differs from plain ({tuple(got.shape)}, "
              f"max abs err {err})")

    def add_time(name, k_ms, p_ms, nbytes, nops):
        st = stats[name]
        st["ms"] += k_ms
        st["plain_ms"] += p_ms
        st["bytes"] += nbytes
        st["ops"] += nops

    # 3. each kernel against its plain version on the card
    for bd in (8, 10):
        plane = torch.from_numpy(rng.integers(
            0, 1 << bd, size=(H_HD, W_HD)).astype(np.int32)).to(dev)
        for s in (4,) + SIZES:
            xs, ys = grid_xy(s, W_HD, H_HD, dev)
            # random positions too, frame edges included
            rx = torch.from_numpy(rng.integers(0, W_HD, 4096).astype(
                np.int32)).to(dev)
            ry = torch.from_numpy(rng.integers(0, H_HD, 4096).astype(
                np.int32)).to(dev)
            rx[:64] = 0
            ry[32:96] = 0
            for px, py in ((xs, ys), (rx, ry)):
                got = rdo.build_ref_lines_device(plane, px, py, s, bd)
                with ops.plain():
                    want = rdo.build_ref_lines_device(plane, px, py, s, bd)
                compare("ref_lines", got, want)
            refs = torch.from_numpy(rng.integers(
                0, 1 << bd, size=(xs.shape[0], 4 * s + 3)).astype(
                    np.int32)).to(dev)
            pk = intra.predict_all_modes_batch(refs, s, bd)
            with ops.plain():
                pp = intra.predict_all_modes_batch(refs, s, bd)
            compare("intra_pred_all", pk, pp)
            orig = torch.from_numpy(rng.integers(
                0, 1 << bd, size=(xs.shape[0], s, s)).astype(np.int32)).to(dev)
            sk = satd.satd_batch(pk, orig)
            with ops.plain():
                sp = satd.satd_batch(pk, orig)
            compare("satd", sk, sp)
            del pp, sp
            if bd != 8 or s not in SIZES:
                continue
            # timings at the main path's shapes (one 1080p frame, size s)
            n = xs.shape[0]
            f_ref = lambda: rdo.build_ref_lines_device(plane, xs, ys, s, bd)
            k_ms = cuda_ms(f_ref)
            with ops.plain():
                p_ms = cuda_ms(f_ref)
            add_time("ref_lines", k_ms, p_ms,
                     ref_lines_read_bytes(H_HD, W_HD, xs, ys, s) + n * 8
                     + n * (4 * s + 3) * 4,
                     10 * n * (4 * s + 3))
            f_int = lambda: intra.predict_all_modes_batch(refs, s, bd)
            k_ms = cuda_ms(f_int)
            with ops.plain():
                p_ms = cuda_ms(f_int, iters=3, warmup=1)
            table_bytes = (33 * 4 * s * s * 2 + 33 * s * s * 2 + 33) * 4
            add_time("intra_pred_all", k_ms, p_ms,
                     n * (4 * s + 3) * 4 + table_bytes + n * 67 * s * s * 4,
                     16 * n * 67 * s * s)
            f_satd = lambda: satd.satd_batch(pk, orig)
            k_ms = cuda_ms(f_satd)
            with ops.plain():
                p_ms = cuda_ms(f_satd, iters=3, warmup=1)
            add_time("satd", k_ms, p_ms,
                     n * 67 * s * s * 4 + n * s * s * 4 + n * 67 * 4,
                     9 * n * 67 * s * s)
            # yardstick: one float32 matmul Hadamard sandwich + abs-sum
            t = 8
            hm = torch.from_numpy(satd.hadamard(t).astype(np.float32)).to(dev)

            def lib_satd():
                d = (pk - orig[:, None]).to(torch.float32)
                d = d.reshape(n, 67, s // t, t, s // t, t).transpose(3, 4)
                had = hm @ d @ hm
                per = had.abs().sum(dim=(-2, -1))
                return ((per + 2) / 4).floor().to(torch.float64).sum(
                    dim=(-2, -1))
            compare("satd", lib_satd().to(torch.int32), sk)
            lib_ms = cuda_ms(lib_satd, iters=3, warmup=1)
            stats["satd"]["library_ms"] = (stats["satd"]["library_ms"] or 0.0
                                           ) + lib_ms
            del pk, refs, orig, sk
        del plane
    # satd at the rectangular and 4-point shapes
    for (h, w) in ((4, 8), (8, 4), (4, 4), (16, 8), (8, 16)):
        pred = torch.from_numpy(rng.integers(0, 1024, size=(5000, 67, h, w))
                                .astype(np.int32)).to(dev)
        orig = torch.from_numpy(rng.integers(0, 1024, size=(5000, h, w))
                                .astype(np.int32)).to(dev)
        got = satd.satd_batch(pred, orig)
        with ops.plain():
            want = satd.satd_batch(pred, orig)
        compare("satd", got, want)
        del pred, orig, got, want

    # the lossy kernels at the main path's shapes: stage A runs DCT2 on the
    # top-3 shortlist ([3N,S,S]) at every size, stage B the 4 other MTS
    # pairs on the winners ([N,S,S]) at 8..32; MIP predicts [N,9,S,S]
    def f64_sandwich(fwd, x, th, tv, bd):
        """Yardstick: the same integer transform as float64 batched
        matmuls with the same shifts (exact: every value < 2^53)."""
        x = x.to(torch.float64)
        if fwd:
            s1 = int(np.log2(x.shape[-1])) + bd - 9
            s2 = int(np.log2(x.shape[-2])) + 6
            t = torch.floor((x @ th.T + 2.0 ** (s1 - 1)) / 2.0 ** s1)
            return torch.floor((tv @ t + 2.0 ** (s2 - 1)) / 2.0 ** s2
                               ).clamp(-32768, 32767)
        s2 = 20 - bd
        t = torch.floor((tv.T @ x + 64.0) / 128.0).clamp(-32768, 32767)
        return torch.floor((t @ th + 2.0 ** (s2 - 1)) / 2.0 ** s2
                           ).clamp(-32768, 32767)

    def time_transform(fwd, x, want, th, tv, bd, bucket=None, mult=1):
        """Kernel, plain and float64-yardstick times of one transform
        launch on x [M,H,W] (counted `mult` times); the yardstick checked
        against `want`.  bucket: the stats dict to add to (the rect
        columns of kernel 4), default the kernel's own."""
        name = "transform_fwd" if fwd else "transform_inv"
        st = (bucket or stats)[name]
        fn = (transform.fwd_transform_batch if fwd
              else transform.inv_transform_batch)
        m, h, w = x.shape
        f = lambda: fn(x, bd, th, tv)
        k_ms = cuda_ms(f)
        with ops.plain():
            p_ms = cuda_ms(f, iters=3, warmup=1)
        st["ms"] += mult * k_ms
        st["plain_ms"] += mult * p_ms
        st["bytes"] += mult * (2 * m * h * w * 4 + (w * w + h * h) * 4)
        st["ops"] += mult * m * h * w * (w + h) * 2
        thm = transform._matrix(th, w, str(dev)).to(torch.float64)
        tvm = transform._matrix(tv, h, str(dev)).to(torch.float64)
        lib = lambda: f64_sandwich(fwd, x, thm, tvm, bd)
        compare(name, lib().to(torch.int32), want)
        st["library_ms"] = (st["library_ms"] or 0.0) + mult * cuda_ms(
            lib, iters=3, warmup=1)

    def time_quant(c, bd, row_lanes=False, bucket=None, mult=1):
        """Kernel and plain times of one quant_rate launch on c [M,H,W]."""
        m, h, w = c.shape
        st = (bucket or stats)["quant_rate"]
        f = lambda: quant.quant_rate(c, 32, bd, row_lanes)
        k_ms = cuda_ms(f)
        with ops.plain():
            p_ms = cuda_ms(f, iters=2, warmup=1)
        st["ms"] += mult * k_ms
        st["plain_ms"] += mult * p_ms
        st["bytes"] += mult * (2 * m * h * w * 4 + m * 4 + 32768 * 4 + 40)
        st["ops"] += mult * 16 * m * h * w

    def kernel_rect_chain(x, th, tv, bd, time_it, bucket, mult):
        """transform_fwd → quant_rate → transform_inv on x [M,H,W] against
        the plain versions (the rate bit for bit), timed into `bucket`."""
        ck = transform.fwd_transform_batch(x, bd, th, tv)
        with ops.plain():
            cp = transform.fwd_transform_batch(x, bd, th, tv)
        compare("transform_fwd", ck, cp)
        rk, dk = quant.quant_rate(ck, 32, bd)
        with ops.plain():
            rp, dp = quant.quant_rate(ck, 32, bd)
        compare("quant_rate", dk, dp)
        compare("quant_rate", rk.view(torch.int32), rp.view(torch.int32))
        ik = transform.inv_transform_batch(dk, bd, th, tv)
        with ops.plain():
            ip = transform.inv_transform_batch(dk, bd, th, tv)
        compare("transform_inv", ik, ip)
        if time_it:
            time_transform(True, x, ck, th, tv, bd, bucket, mult)
            time_transform(False, dk, ik, th, tv, bd, bucket, mult)
            time_quant(ck, bd, False, bucket, mult)

    for bd in (8, 10):
        for s in SIZES:
            n = (H_HD // s) * (W_HD // s)
            lim = 1 << bd
            resi_a = torch.from_numpy(rng.integers(
                -lim + 1, lim, size=(3 * n, s, s)).astype(np.int32) >> 2
                ).to(dev)
            passes = [(0, resi_a)] + ([(mi, resi_a[:n]) for mi in
                                       range(1, 5)] if s in MTS_SIZES else [])
            for mi, x in passes:
                th, tv = transform.MTS_TR[mi]
                m = x.shape[0]
                ck = transform.fwd_transform_batch(x, bd, th, tv)
                with ops.plain():
                    cp = transform.fwd_transform_batch(x, bd, th, tv)
                compare("transform_fwd", ck, cp)
                rk, dk = quant.quant_rate(ck, 32, bd)
                with ops.plain():
                    rp, dp = quant.quant_rate(ck, 32, bd)
                compare("quant_rate", dk, dp)
                compare("quant_rate", rk.view(torch.int32),
                        rp.view(torch.int32))
                ik = transform.inv_transform_batch(dk, bd, th, tv)
                with ops.plain():
                    ip = transform.inv_transform_batch(dk, bd, th, tv)
                compare("transform_inv", ik, ip)
                del cp, rp, dp, ip
                if bd != 8:
                    continue
                time_transform(True, x, ck, th, tv, bd)
                time_transform(False, dk, ik, th, tv, bd)
                time_quant(ck, bd)
                del ck, rk, dk, ik
            del resi_a, passes
            if s not in MTS_SIZES:
                continue
            refs = torch.from_numpy(rng.integers(
                0, 1 << bd, size=(n, 4 * s + 3)).astype(np.int32)).to(dev)
            refs[:64] = refs[:64, :1]                     # flat lines
            mk = mip.mip_predict_all_batch(refs, s, bd)
            with ops.plain():
                mp = mip.mip_predict_all_batch(refs, s, bd)
            compare("mip_pred_all", mk, mp)
            del mk, mp
            if bd == 8:
                f = lambda: mip.mip_predict_all_batch(refs, s, bd)
                k_ms = cuda_ms(f)
                with ops.plain():
                    p_ms = cuda_ms(f, iters=3, warmup=1)
                add_time("mip_pred_all", k_ms, p_ms,
                         n * (4 * s + 3) * 4 + n * 9 * s * s * 4
                         + 9 * 64 * 8 * 4,
                         n * (9 * 64 * 16 + 9 * s * s * 8))
            del refs
    # the slice-2b kernels at the main path's shapes: stage C runs the
    # LFNST pair on the winners' DCT2 coefficients ([N,S,S], both indices)
    # at every size; the chroma decision runs luma_ds once per frame, and
    # per size and chroma plane intra_pred_one for DM and cclm_models for
    # the three LM variants on [N] blocks of S/2
    lf = lfnst._kernels_dev(str(dev))
    for bd in (8, 10):
        for s in SIZES:
            n = (H_HD // s) * (W_HD // s)
            coeff = torch.from_numpy(rng.integers(
                -32768, 32768, size=(n, s, s)).astype(np.int32)).to(dev)
            coeff[: n // 2] //= 64
            modes = torch.from_numpy(rng.integers(0, 76, n).astype(
                np.int32)).to(dev)
            g, t = lfnst._sets_batch(modes)
            if bd == 8:
                # stage C's own DCT2 of the winners' residuals ([N,S,S])
                resi = (coeff >> 8).contiguous()
                time_transform(True, resi, transform.fwd_transform_batch(
                    resi, bd), 0, 0, bd)
            for li in (1, 2):
                sec = lfnst.fwd_lfnst_batch(coeff, modes, li)
                with ops.plain():
                    want = lfnst.fwd_lfnst_batch(coeff, modes, li)
                compare("lfnst_fwd", sec, want)
                inv = lfnst.inv_lfnst_batch(sec, modes, li)
                with ops.plain():
                    want = lfnst.inv_lfnst_batch(sec, modes, li)
                compare("lfnst_inv", inv, want)
                if s == 8:                     # stage C's 8×8 rate order
                    rk, dk = quant.quant_rate(sec, 32, bd, True)
                    with ops.plain():
                        rp, dp = quant.quant_rate(sec, 32, bd, True)
                    compare("quant_rate", dk, dp)
                    compare("quant_rate", rk.view(torch.int32),
                            rp.view(torch.int32))
                del want
                if bd != 8:
                    continue
                # stage C's quant_rate and inverse DCT2 on [N,S,S]
                time_quant(sec, bd, s == 8)
                time_transform(False, inv, transform.inv_transform_batch(
                    inv, bd), 0, 0, bd)
                b64 = lf[:, li - 1][g.long()].to(torch.float64)  # [N,16,64]

                def lib_fwd():
                    c8 = coeff[:, :8, :8]
                    c8 = torch.where(t[:, None, None], c8.transpose(1, 2),
                                     c8).reshape(n, 64, 1)
                    y = torch.bmm(b64, c8.to(torch.float64))
                    y = torch.floor((y + 32.0) / 64.0).clamp(-32768, 32767)
                    out = torch.zeros((n, s, s), dtype=torch.float64,
                                      device=dev)
                    out[:, :4, :4] = y.reshape(n, 4, 4)
                    return out

                def lib_inv():
                    y = sec[:, :4, :4].reshape(n, 1, 16).to(torch.float64)
                    c8 = torch.floor((torch.bmm(y, b64) + 32.0) / 64.0
                                     ).clamp(-32768, 32767).reshape(n, 8, 8)
                    out = torch.zeros((n, s, s), dtype=torch.float64,
                                      device=dev)
                    out[:, :8, :8] = torch.where(t[:, None, None],
                                                 c8.transpose(1, 2), c8)
                    return out

                for name, fn, inp, lib, want in (
                        ("lfnst_fwd", lfnst.fwd_lfnst_batch, coeff, lib_fwd,
                         sec),
                        ("lfnst_inv", lfnst.inv_lfnst_batch, sec, lib_inv,
                         inv)):
                    f = lambda: fn(inp, modes, li)
                    k_ms = cuda_ms(f)
                    with ops.plain():
                        p_ms = cuda_ms(f, iters=3, warmup=1)
                    # bytes it must move: the 64 (forward) or 16 (inverse)
                    # coefficients it reads, the mode, the 1 KB kernel of
                    # each of the 4 sets, and the S×S block it writes
                    n_in = 64 if name == "lfnst_fwd" else 16
                    add_time(name, k_ms, p_ms,
                             n * (n_in * 4 + 4 + s * s * 4) + 4 * 1024,
                             n * 2 * 16 * 64)
                    compare(name, lib().to(torch.int32), want)
                    stats[name]["library_ms"] = (
                        stats[name]["library_ms"] or 0.0) + cuda_ms(
                            lib, iters=3, warmup=1)
            del coeff, sec, inv
        # luma downsample of one frame, then the chroma decision's models
        # and DM prediction per size and plane
        luma = torch.from_numpy(rng.integers(0, 1 << bd, size=(
            H_HD, W_HD)).astype(np.int32)).to(dev)
        ds = cclm.luma_ds_plane_dev(luma)
        with ops.plain():
            want = cclm.luma_ds_plane_dev(luma)
        compare("luma_ds", ds, want)
        if bd == 8:
            f = lambda: cclm.luma_ds_plane_dev(luma)
            k_ms = cuda_ms(f)
            with ops.plain():
                p_ms = cuda_ms(f)
            add_time("luma_ds", k_ms, p_ms,
                     H_HD * W_HD * 4 + H_HD * W_HD, 8 * H_HD * W_HD // 4)
            wk = torch.tensor([[1.0, 2.0, 1.0], [1.0, 2.0, 1.0]],
                              dtype=torch.float64, device=dev)[None, None]

            def lib_ds():
                x = torch.nn.functional.pad(
                    luma.to(torch.float64)[None, None], (1, 1, 0, 0),
                    mode="replicate")
                y = torch.nn.functional.conv2d(x, wk, stride=2)[0, 0]
                return torch.floor((y + 4.0) / 8.0)
            compare("luma_ds", lib_ds().to(torch.int32), ds)
            stats["luma_ds"]["library_ms"] = cuda_ms(lib_ds)
        planes = [torch.from_numpy(rng.integers(0, 1 << bd, size=(
            H_HD // 2, W_HD // 2)).astype(np.int32)).to(dev)
            for _ in range(2)]
        for s in SIZES:
            cs = s // 2
            cx, cy = grid_xy(s, W_HD, H_HD, dev)
            cx, cy = cx >> 1, cy >> 1
            n = cx.shape[0]
            dm = torch.from_numpy(rng.integers(0, 67, n).astype(
                np.int32)).to(dev)
            for plane in planes:
                for v in (1, 2, 3):
                    got = cclm.derive_models_batch_dev(ds, plane, cx, cy, cs,
                                                       bd, v)
                    with ops.plain():
                        want = cclm.derive_models_batch_dev(
                            ds, plane, cx, cy, cs, bd, v)
                    compare("cclm_models", got[0], want[0])
                    compare("cclm_models", got[1], want[1])
                    if bd == 8:
                        f = lambda: cclm.derive_models_batch_dev(
                            ds, plane, cx, cy, cs, bd, v)
                        k_ms = cuda_ms(f)
                        with ops.plain():
                            p_ms = cuda_ms(f, iters=3, warmup=1)
                        add_time("cclm_models", k_ms, p_ms,
                                 cclm_models_bytes(cclm, cx, cy, cs,
                                                   H_HD // 2, W_HD // 2, v),
                                 n * 60)
                refs = rdo.build_ref_lines_device(plane, cx, cy, cs, bd)
                got = intra.predict_modes_batch(refs, dm, cs, bd)
                with ops.plain():
                    want = intra.predict_modes_batch(refs, dm, cs, bd)
                compare("intra_pred_one", got, want)
                if bd == 8:
                    f = lambda: intra.predict_modes_batch(refs, dm, cs, bd)
                    k_ms = cuda_ms(f)
                    with ops.plain():
                        p_ms = cuda_ms(f, iters=3, warmup=1)
                    add_time("intra_pred_one", k_ms, p_ms,
                             n * ((4 * cs + 3) * 4 + 4 + cs * cs * 4),
                             16 * n * cs * cs)
        del luma, ds, planes
    # the motion search's kernels (slice 4a), per 1080p B picture with 2
    # refs per list (R = 4) as the RA main path runs them: me_prep for the
    # current picture and the one new reference, me_coarse once, me_int
    # and me_qpel per ref at 64, 32 and 16 and for the 8x8 children.
    # Exactness on the motion clip (8 bit) and on noise (10 bit, every SSE
    # above 2^24); times on the motion clip.
    me_clip = [f.y for f in motion_clip(5, W_HD, H_HD)]
    for bd in (8, 10):
        if bd == 8:
            planes = [torch.from_numpy(y).to(dev) for y in me_clip]
        else:
            planes = [torch.from_numpy(rng.integers(0, 1024, (H_HD, W_HD))
                                       .astype(np.int32)).to(dev)
                      for _ in range(5)]
        time_it = bd == 8
        cur, refs = planes[2], [planes[i] for i in (1, 0, 3, 4)]
        got = me.prep_ref(cur)
        with ops.plain():
            want = me.prep_ref(cur)
        compare("me_prep", got[0], want[0])
        compare("me_prep", got[1], want[1])
        yds = got[1]
        preps = [me.prep_ref(r) for r in refs]
        refpad = torch.stack([p[0] for p in preps])
        refds = torch.stack([p[1] for p in preps])
        if time_it:
            f = lambda: me.prep_ref(cur)
            k_ms = cuda_ms(f)
            with ops.plain():
                p_ms = cuda_ms(f)
            h4, w4 = (H_HD + 3) // 4, (W_HD + 3) // 4
            nb = (H_HD * W_HD + (H_HD + 32) * (W_HD + 32) + h4 * w4) * 4
            add_time("me_prep", 2 * k_ms, 2 * p_ms, 2 * nb,
                     2 * ((H_HD + 32) * (W_HD + 32) + 17 * h4 * w4))
        grids = me.coarse_search(yds, refds)
        with ops.plain():
            want = me.coarse_search(yds, refds)
        for s in (16, 32, 64):
            compare("me_coarse", grids[s], want[s])
        if time_it:
            f = lambda: me.coarse_search(yds, refds)
            k_ms = cuda_ms(f)
            with ops.plain():
                p_ms = cuda_ms(f, iters=2, warmup=1)
            n4y, n4x = me._coarse_dims(h4, w4)
            add_time("me_coarse", k_ms, p_ms,
                     5 * h4 * w4 * 4 + 289 * 4
                     + 4 * n4y * n4x * 8 * (1 + 1 / 4 + 1 / 16),
                     4 * 289 * (3 * h4 * w4 + 4 * n4y * n4x))
        _, lam_m = rdo.lambda_f32(32)
        qcases = {}
        for s in (64, 32, 16, 8):
            ps = 16 if s == 8 else s
            if ps == 16:
                ny8, nx8 = H_HD // 8, W_HD // 8
                nye, nxe = (ny8 + 1) // 2, (nx8 + 1) // 2
            else:
                nye, nxe = H_HD // ps, W_HD // ps
            ry = torch.arange(nye * ps, device=dev).clamp(max=H_HD - 1)
            rx = torch.arange(nxe * ps, device=dev).clamp(max=W_HD - 1)
            yp = cur[ry][:, rx]
            xs_, ys_ = grid_xy(ps, nxe * ps, nye * ps, dev)
            g = grids[ps]
            giy = (ys_ // ps).long().clamp(max=g.shape[1] - 1)
            gix = (xs_ // ps).long().clamp(max=g.shape[2] - 1)
            if s == 8:
                ob = (yp.reshape(nye, 2, 8, nxe, 2, 8)
                      .permute(0, 3, 1, 4, 2, 5).reshape(-1, 8, 8)
                      .contiguous())
                xs_ = (xs_[:, None] + torch.tensor([0, 8, 0, 8], device=dev,
                                                   dtype=torch.int32)
                       ).reshape(-1)
                ys_ = (ys_[:, None] + torch.tensor([0, 0, 8, 8], device=dev,
                                                   dtype=torch.int32)
                       ).reshape(-1)
            else:
                ob = (yp.reshape(nye, ps, nxe, ps).permute(0, 2, 1, 3)
                      .reshape(-1, ps, ps).contiguous())
            nblk = ob.shape[0]
            for r in range(4):
                cy = g[r, giy, gix, 0]
                cx = g[r, giy, gix, 1]
                if s == 8:      # the parents' clipped centres
                    _, _, cy, cx = me.int_refine(refpad[r], parent_ob,
                                                 parent_ys, parent_xs, cy, cx,
                                                 lam_m, 16, H_HD, W_HD)
                    cy, cx = cy.repeat_interleave(4), cx.repeat_interleave(4)
                args = (refpad[r], ob, ys_, xs_, cy, cx, lam_m, s, H_HD,
                        W_HD)
                ik = me.int_refine(*args)
                with ops.plain():
                    ip = me.int_refine(*args)
                for a, b in zip(ik, ip):
                    compare("me_int", a, b)
                qargs = (refpad[r], ob, ys_, xs_, ik[0], ik[1], lam_m, s, bd)
                qcases.setdefault(s, []).append(qargs)
                qk = me.qpel_refine(*qargs)
                with ops.plain():
                    qp_ = me.qpel_refine(*qargs)
                compare("me_qpel", qk[0], qp_[0])
                compare("me_qpel", qk[1], qp_[1])
                compare("me_qpel", qk[2].view(torch.int32),
                        qp_[2].view(torch.int32))
                compare("me_qpel", qk[3], qp_[3])
                del ip, qp_
                if not time_it:
                    continue
                f = lambda: me.int_refine(*args)
                k_ms = cuda_ms(f)
                with ops.plain():
                    p_ms = cuda_ms(f, iters=1, warmup=0)
                add_time("me_int", k_ms, p_ms,
                         nblk * (s * s + 4 * 4) * 4
                         + (H_HD + 32) * (W_HD + 32) * 4 + 4096 * 4,
                         nblk * 81 * (3 * s * s + 4))
                # the kernel's own time is taken per size below
                with ops.plain():
                    p_ms = cuda_ms(lambda: me.qpel_refine(*qargs), iters=1,
                                   warmup=0)
                add_time("me_qpel", 0.0, p_ms, qpel_bytes(s, nblk),
                         nblk * qpel_ops(s))
                m2 = s + 12
                # yardstick: the DCTIF pass of all 49 offsets as one
                # float64 conv2d of the 16 phase kernels over the windows;
                # it reproduces the kernel's prediction of the winner
                oy = ys_ + 16 + ik[0] - 6
                ox = xs_ + 16 + ik[1] - 6
                kk = torch.arange(m2, device=dev)
                w2 = refpad[r][(oy[:, None] + kk)[:, :, None],
                               (ox[:, None] + kk)[:, None, :]]
                w2 = w2.to(torch.float64)[:, None]
                lf = torch.from_numpy(np.asarray(LUMA_FILTERS, np.float64)
                                      ).to(dev)
                kern = (lf[:, None, :, None] * lf[None, :, None, :]
                        ).reshape(16, 1, 8, 8)
                lib = lambda: torch.nn.functional.conv2d(w2, kern)
                acc = lib()
                qy, qx = qk[0] - 4 * ik[0], qk[1] - 4 * ik[1]
                r0, c0 = (qy >> 2) + 3, (qx >> 2) + 3
                ph = (qy & 3) * 4 + (qx & 3)
                sel = acc[torch.arange(nblk, device=dev)[:, None, None],
                          ph[:, None, None],
                          (r0[:, None] + torch.arange(s, device=dev))[:, :,
                                                                       None],
                          (c0[:, None] + torch.arange(s, device=dev))[:, None,
                                                                       :]]
                libp = torch.floor((sel + 2048.0) / 4096.0).clamp(0, 255)
                compare("me_qpel", libp.to(torch.int32), qk[3])
                stats["me_qpel"]["library_ms"] = (
                    stats["me_qpel"]["library_ms"] or 0.0) + cuda_ms(
                        lib, iters=3, warmup=1)
                del w2, acc, sel, libp
            if ps == 16 and s == 16:
                parent_ob, parent_ys, parent_xs = ob, ys_, xs_
        if time_it:
            # the kernel's time per size: the median of 7 timed runs of
            # the four references' launches
            sizes = me_qpel_sizes(me, qcases)
            stats["me_qpel"]["ms"] = sum(v["ms"] for v in sizes.values())
            print(f"[3] me_qpel per size, 1080p B picture, 4 refs, median "
                  f"of 7 (CUDA events): {json.dumps(sizes)}", flush=True)
        del qcases
        del planes, refpad, refds, preps
    # the slice-2c kernels at the 1080p shapes of the MTT + ISP main path,
    # per frame: the reference lines and 67 modes of the ten rect lattice
    # shapes and the four rect TT mid planes, stage A (DCT2 on the top-3,
    # [3N,H,W]) and stage B (4 MTS pairs, [N,H,W], sides 8..32) there; and
    # the ISP stage of every shape with sides 8..32 — per direction and
    # sub-TU: ref lines, one-mode prediction, transform, quant_rate and
    # inverse at [N,sh,sw] with the implicit pair.  Exact against the plain
    # versions at 8 and 10 bit (random planes and lines, random modes);
    # times at 8 bit, each distinct launch timed once and counted as often
    # as the path launches it.
    rect = {k: {"ms": 0.0, "plain_ms": 0.0, "bytes": 0.0, "ops": 0.0,
                "library_ms": None}
            for k in ("transform_fwd", "transform_inv", "quant_rate")}
    grids = [((w, h), grid_xy_rect(w, h, W_HD, H_HD, dev))
             for w, h in MTT_RECT]
    grids += [(wh, mid_xy(desc, W_HD, H_HD, dev))
              for desc, wh in MID_RECT]
    isp_runs = isp_launches(W_HD, H_HD)
    for bd in (8, 10):
        plane = torch.from_numpy(rng.integers(
            0, 1 << bd, size=(H_HD, W_HD)).astype(np.int32)).to(dev)
        rx = torch.from_numpy(rng.integers(0, W_HD, 4096).astype(
            np.int32)).to(dev)
        ry = torch.from_numpy(rng.integers(0, H_HD, 4096).astype(
            np.int32)).to(dev)
        rx[:64] = 0
        ry[32:96] = 0
        time_it = bd == 8
        for (w, h), (xs, ys) in grids:
            n = xs.shape[0]
            for px, py in ((xs, ys), (rx, ry)):
                got = rdo.build_ref_lines_device_rect(plane, px, py, w, h, bd)
                with ops.plain():
                    want = rdo.build_ref_lines_device_rect(plane, px, py, w,
                                                           h, bd)
                compare("ref_lines_rect", got, want)
            refs = torch.from_numpy(rng.integers(
                0, 1 << bd, size=(n, 2 * h + 2 * w + 3)).astype(
                    np.int32)).to(dev)
            refs[:64] = refs[:64, :1]
            pk = intra.predict_all_modes_batch_rect(refs, w, h, bd)
            with ops.plain():
                pp = intra.predict_all_modes_batch_rect(refs, w, h, bd)
            compare("intra_pred_all_rect", pk, pp)
            del pp
            if time_it:
                f_ref = lambda: rdo.build_ref_lines_device_rect(
                    plane, xs, ys, w, h, bd)
                k_ms = cuda_ms(f_ref)
                with ops.plain():
                    p_ms = cuda_ms(f_ref)
                add_time("ref_lines_rect", k_ms, p_ms,
                         ref_lines_read_bytes(H_HD, W_HD, xs, ys, w, h)
                         + n * 8 + n * (2 * h + 2 * w + 3) * 4,
                         10 * n * (2 * h + 2 * w + 3))
                f_int = lambda: intra.predict_all_modes_batch_rect(
                    refs, w, h, bd)
                k_ms = cuda_ms(f_int)
                with ops.plain():
                    p_ms = cuda_ms(f_int, iters=2, warmup=1)
                table_bytes = 49 * (4 * w * h * 2 * 2 + w * h * 2 * 2 + 2) * 4
                add_time("intra_pred_all_rect", k_ms, p_ms,
                         n * (2 * h + 2 * w + 3) * 4 + table_bytes
                         + n * 67 * w * h * 4, 16 * n * 67 * w * h)
            del pk, refs
            # stages A and B of the rect shape
            lim = 1 << bd
            resi_a = torch.from_numpy(rng.integers(
                -lim + 1, lim, size=(3 * n, h, w)).astype(np.int32) >> 2
                ).to(dev)
            mts_ok = 8 <= w <= 32 and 8 <= h <= 32
            passes = [(0, resi_a)] + ([(mi, resi_a[:n]) for mi in
                                       range(1, 5)] if mts_ok else [])
            for mi, x in passes:
                th, tv = transform.MTS_TR[mi]
                kernel_rect_chain(x, th, tv, bd, time_it, rect, 1)
            del resi_a, passes
        for (sw, sh, n, th, tv, square, mult) in isp_runs:
            lim = 1 << bd
            xs = torch.from_numpy(rng.integers(0, W_HD - sw, n).astype(
                np.int32)).to(dev)
            ys = torch.from_numpy(rng.integers(0, H_HD - sh, n).astype(
                np.int32)).to(dev)
            modes = torch.from_numpy(rng.integers(0, 67, n).astype(
                np.int32)).to(dev)
            if not square:
                got = rdo.build_ref_lines_device_rect(plane, xs, ys, sw, sh,
                                                      bd)
                with ops.plain():
                    want = rdo.build_ref_lines_device_rect(plane, xs, ys, sw,
                                                           sh, bd)
                compare("ref_lines_rect", got, want)
                pk = intra.predict_modes_batch_rect(got, modes, sw, sh, bd)
                with ops.plain():
                    pp = intra.predict_modes_batch_rect(got, modes, sw, sh,
                                                        bd)
                compare("intra_pred_one_rect", pk, pp)
                if time_it:
                    f_ref = lambda: rdo.build_ref_lines_device_rect(
                        plane, xs, ys, sw, sh, bd)
                    k_ms = cuda_ms(f_ref)
                    with ops.plain():
                        p_ms = cuda_ms(f_ref)
                    add_time("ref_lines_rect", mult * k_ms, mult * p_ms,
                             mult * (ref_lines_read_bytes(
                                 H_HD, W_HD, xs, ys, sw, sh) + n * 8
                                 + n * (2 * sh + 2 * sw + 3) * 4),
                             mult * 10 * n * (2 * sh + 2 * sw + 3))
                    f_one = lambda: intra.predict_modes_batch_rect(
                        got, modes, sw, sh, bd)
                    k_ms = cuda_ms(f_one)
                    with ops.plain():
                        p_ms = cuda_ms(f_one, iters=3, warmup=1)
                    table_bytes = 49 * (4 * sw * sh * 2 * 2
                                        + sw * sh * 2 * 2 + 2) * 4
                    add_time("intra_pred_one_rect", mult * k_ms,
                             mult * p_ms,
                             mult * (n * ((2 * sh + 2 * sw + 3) * 4 + 4
                                          + sw * sh * 4) + table_bytes),
                             mult * 16 * n * sw * sh)
                del got, pk, pp
            resi = torch.from_numpy(rng.integers(
                -lim + 1, lim, size=(n, sh, sw)).astype(np.int32) >> 2
                ).to(dev)
            kernel_rect_chain(resi, th, tv, bd, time_it, rect, mult)
            del resi
        del plane
    for name, st in rect.items():
        st["bound_ms"], st["bound_by"] = bound_ms(st["bytes"], st["ops"])
        print(f"[3] {name} at the rect and ISP shapes: exact vs plain; per "
              f"1080p MTT frame (all those launches): kernel "
              f"{st['ms']:.3f} ms, plain {st['plain_ms']:.3f} ms, bound "
              f"{st['bound_ms']:.3f} ms ({st['bound_by']}), library "
              f"{st['library_ms']}", flush=True)
    # the slice-4b kernels at the 1080p shapes of the 4b main path: the
    # affine search (affine_search, then affine_dctif for the winner's
    # prediction) per 1080p B picture, reference 0 of each list at sizes
    # 64, 32 and 16 (16 on the grid extended for the 8x8 children), at the
    # translational winners of me_int/me_qpel; me_block_err per 1080p MCTF
    # anchor (four neighbours).  Exact against the plain versions on the
    # tool clip (8 bit) and on noise (10 bit); times on the tool clip.
    t4 = [torch.from_numpy(y).to(dev) for y in tool_clip(5, W_HD, H_HD)]
    _, lam_m = rdo.lambda_f32(32)
    for bd in (8, 10):
        if bd == 8:
            planes = t4
        else:
            planes = [torch.from_numpy(rng.integers(0, 1024, (H_HD, W_HD))
                                       .astype(np.int32)).to(dev)
                      for _ in range(5)]
        time_it = bd == 8
        cur, refs = planes[2], (planes[1], planes[3])
        preps = [me.prep_ref(r) for r in refs]
        grids = me.coarse_search(me.prep_ref(cur)[1],
                                 torch.stack([p[1] for p in preps]))
        for s in (64, 32, 16):
            if s == 16:
                nye, nxe = (H_HD // 8 + 1) // 2, (W_HD // 8 + 1) // 2
            else:
                nye, nxe = H_HD // s, W_HD // s
            ry = torch.arange(nye * s, device=dev).clamp(max=H_HD - 1)
            rx = torch.arange(nxe * s, device=dev).clamp(max=W_HD - 1)
            ob = (cur[ry][:, rx].reshape(nye, s, nxe, s).permute(0, 2, 1, 3)
                  .reshape(-1, s, s).contiguous())
            xs_, ys_ = grid_xy(s, nxe * s, nye * s, dev)
            g = grids[s]
            giy = (ys_ // s).long().clamp(max=g.shape[1] - 1)
            gix = (xs_ // s).long().clamp(max=g.shape[2] - 1)
            nblk = ob.shape[0]
            for li in range(2):
                rp = preps[li][0]
                iy, ix, _, _ = me.int_refine(rp, ob, ys_, xs_,
                                             g[li, giy, gix, 0],
                                             g[li, giy, gix, 1], lam_m, s,
                                             H_HD, W_HD)
                mvy, mvx, _, _ = me.qpel_refine(rp, ob, ys_, xs_, iy, ix,
                                                lam_m, s, bd)
                fargs = (rp, ob, ys_, xs_, mvy, mvx, iy, ix, lam_m, s, bd)
                fk = me.affine_fields(*fargs)
                with ops.plain():
                    fp = me.affine_fields(*fargs)
                compare("affine_search", fk[0].view(torch.int32),
                        fp[0].view(torch.int32))
                for a, b in zip(fk[1:], fp[1:]):
                    compare("affine_search", a, b)
                dargs = (rp, ys_, xs_, iy, ix, fk[3], fk[4], s, bd)
                pk = me.affine_dctif_pred(*dargs)
                with ops.plain():
                    pp = me.affine_dctif_pred(*dargs)
                compare("affine_dctif", pk, pp)
                del fp, pp
                if not time_it:
                    continue
                f = lambda: me.affine_fields(*fargs)
                k_ms = cuda_ms(f, iters=3, warmup=1)
                with ops.plain():
                    p_ms = cuda_ms(f, iters=1, warmup=0)
                m2 = s + 12
                plane_b = (H_HD + 32) * (W_HD + 32) * 4
                add_time("affine_search", k_ms, p_ms,
                         plane_b + nblk * (s * s + 4) * 4
                         + nblk * (3 + 2 * (s // 4) ** 2) * 4
                         + (64 + 4096) * 4,
                         nblk * 57 * s * s * AFF_OPS_PER_SAMPLE)
                f = lambda: me.affine_dctif_pred(*dargs)
                k_ms = cuda_ms(f)
                with ops.plain():
                    p_ms = cuda_ms(f, iters=1, warmup=0)
                add_time("affine_dctif", k_ms, p_ms,
                         plane_b + nblk * (4 + 2 * (s // 4) ** 2) * 4
                         + nblk * s * s * 4,
                         nblk * s * s * 2 * 8 * 9)
                # yardstick: the 16 DCTIF phases of every window as one
                # float64 conv2d; each sample takes its subblock's phase
                # and offset, rounded half to even
                kk = torch.arange(m2, device=dev)
                w2 = rp[(ys_ + 10 + iy)[:, None, None] + kk[None, :, None],
                        (xs_ + 10 + ix)[:, None, None] + kk[None, None, :]]
                w2 = w2.to(torch.float64)[:, None]
                lf = torch.from_numpy(np.asarray(LUMA_FILTERS, np.float64)
                                      ).to(dev)
                kern = (lf[:, None, :, None] * lf[None, :, None, :]
                        ).reshape(16, 1, 8, 8)
                lib = lambda: torch.nn.functional.conv2d(w2, kern)
                acc = lib()
                rep = lambda t: t.repeat_interleave(4, 1).repeat_interleave(
                    4, 2).long()
                qy, qx = rep(fk[3]), rep(fk[4])
                ar = torch.arange(s, device=dev)
                sel = acc[torch.arange(nblk, device=dev)[:, None, None],
                          (qy & 3) * 4 + (qx & 3),
                          ar[None, :, None] + (qy >> 2) + 3,
                          ar[None, None, :] + (qx >> 2) + 3]
                libp = torch.round(sel / 4096.0).clamp(0, 255)
                compare("affine_dctif", libp.to(torch.int32), pk)
                stats["affine_dctif"]["library_ms"] = (
                    stats["affine_dctif"]["library_ms"] or 0.0) + cuda_ms(
                        lib, iters=3, warmup=1)
                del w2, acc, sel, libp
        # me_block_err: the MCTF search of one neighbour (me_pred_v2) and
        # the block error alone
        nref = planes[1]
        rpad, rds = me.prep_ref(nref)
        c16 = me.coarse_search(me.prep_ref(cur)[1], rds[None])[16][0]
        pk = me.me_pred_v2(cur, rpad, c16, W_HD, H_HD, bd, lam_m)
        with ops.plain():
            pp = me.me_pred_v2(cur, rpad, c16, W_HD, H_HD, bd, lam_m)
        compare("me_block_err", pk[0], pp[0])
        compare("me_block_err", pk[1].view(torch.int32),
                pp[1].view(torch.int32))
        ny16, nx16 = H_HD // 16, W_HD // 16
        ob16 = (cur[:ny16 * 16, :nx16 * 16].reshape(ny16, 16, nx16, 16)
                .permute(0, 2, 1, 3).reshape(-1, 16, 16).contiguous())
        pred16 = (pk[0].reshape(ny16, 16, nx16, 16).permute(0, 2, 1, 3)
                  .reshape(-1, 16, 16).contiguous())
        if time_it:
            f = lambda: me.block_err(pred16, cur, ny16, nx16)
            k_ms = cuda_ms(f)
            with ops.plain():
                p_ms = cuda_ms(f, iters=3, warmup=1)
            nb = ny16 * nx16
            add_time("me_block_err", 4 * k_ms, 4 * p_ms,
                     4 * (nb * 256 * 4 * 2 + H_HD * W_HD * 4 + nb * 4),
                     4 * nb * 256 * 3)
            sq = (pk[0] - cur[:ny16 * 16, :nx16 * 16]).to(torch.float32
                                                          ) ** 2
            lib = lambda: torch.nn.functional.avg_pool2d(sq[None, None], 16)
            stats["me_block_err"]["library_ms"] = 4 * cuda_ms(lib)
        del pk, pp, ob16, pred16
        del planes, preps, grids
    del t4
    torch.cuda.synchronize()
    for name, st in stats.items():
        if name in (("sao_stats", "alf_stats") + KERNELS_DEC + KERNELS_SHARD
                    + KERNELS_R4):
            continue        # timed on a 2b recon after [7]; the decoder's in
            # [19]; tile_edge_deblock in [22]; slice 7's in [27]
        st["bound_ms"], st["bound_by"] = bound_ms(st["bytes"], st["ops"])
        print(f"[3] {name}: exact vs plain; per 1080p frame (all its "
              f"launches): kernel {st['ms']:.3f} ms, plain "
              f"{st['plain_ms']:.3f} ms, bound {st['bound_ms']:.3f} ms "
              f"({st['bound_by']}), library {st['library_ms']}", flush=True)

    # 4. the 1080p search vectors: kernels against the plain path
    frames = [synth_frame(W_HD, H_HD, t) for t in range(2)]
    lossless_frames = frames[:1]
    shapes = rdo._candidate_shapes(64, 8, False)
    vec = torch.from_numpy(rdo.pack_planes(frames[0].y)).to(dev)
    vec2b = torch.from_numpy(rdo.pack_planes(frames[0].y, frames[0].cb,
                                             frames[0].cr)).to(dev)
    for label, v, lossless, lfnst_on, chroma_on in (
            ("lossless", vec, True, False, False),
            ("lossy", vec, False, False, False),
            ("2b", vec2b, False, True, True)):
        search = lambda: rdo.eval_all_sizes(v, shapes, 32, 8, W_HD, H_HD,
                                            lossless, lfnst_on, chroma_on)
        got = search()
        with ops.plain():
            want = search()
        check(torch.equal(got, want),
              f"1080p search vector ({label}): kernels != plain")
        search_ms = cuda_ms(search, iters=3, warmup=1)
        with ops.plain():
            search_plain_ms = cuda_ms(search, iters=1, warmup=0)
        extra = ""
        if chroma_on:
            res = rdo.unpack_results(got.cpu().numpy(), shapes, W_HD, H_HD)
            wins = {sh[0]: int((r[3] > 0).sum()) for sh, r in res.items()}
            hist = np.bincount(np.concatenate(
                [r[4].ravel() for r in res.values()]), minlength=4)
            extra = (f"; stage C (LFNST) won in {wins} blocks by size; "
                     f"chroma modes DM/LM/LM_L/LM_T {hist.tolist()}")
        print(f"[4] 1080p {label} search vector ({got.numel()} int32) "
              f"bit-equal to the plain path; one frame's search "
              f"{search_ms:.3f} ms (plain {search_plain_ms:.3f} ms){extra}",
              flush=True)

    # 5. the lossless main path (slice 1), one frame, counted
    perf.reset()
    torch.cuda.synchronize()
    ops.reset_counts()
    t0 = time.perf_counter()
    bs, recons, _ = encode_sequence(lossless_frames, qp=32, lossless=True)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = dict(ops.COUNTS)
    for f, r in zip(lossless_frames, recons):
        for a, b in ((f.y, r.y), (f.cb, r.cb), (f.cr, r.cr)):
            check(np.array_equal(a, b), "1080p lossless recon != source")
    types = [n.nal_type for n in read_annexb(bs)]
    check(types[:2] == [15, 16], f"stream does not start with SPS, PPS: "
          f"{types[:4]}")
    for name in ops.COUNTS:
        want_n = (len(SIZES) * len(lossless_frames)
                  if name in LOSSLESS_KERNELS else 0)
        check(launches[name] == want_n,
              f"{name}: {launches[name]} launches on the lossless main "
              f"path, expected {want_n}")
    print(f"[5] lossless main path: 1 frame 1920x1080 AI QP32 on {kind}: "
          f"{len(bs)} bytes, {elapsed:.2f} s, "
          f"{len(lossless_frames) / elapsed:.4f} frames/s; recon == source; "
          f"launches {launches}; phases (thread-seconds) "
          f"{json.dumps(perf.report())}", flush=True)

    # 6. the lossy main path (slice 2a), two frames, counted
    lossy_sps = dict(deblocking=True, mts_intra=True, mip=True)
    sps_2b = dict(lossy_sps, lfnst=True, cclm=True)

    def lossy_path(sps_kw, expected):
        enc = Encoder(SPS(width=W_HD, height=H_HD, **sps_kw),
                      PPS(init_qp=32))
        perf.reset()
        torch.cuda.synchronize()
        ops.reset_counts()
        t0 = time.perf_counter()
        coded, leaves = [], []
        for poc, f in enumerate(frames):
            coded.append(enc.encode_frame(f, poc))
            leaves += enc.last_leaves
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = dict(ops.COUNTS)
        for name in ops.COUNTS:
            want_n = expected.get(name, 0) * len(frames)
            check(launches[name] == want_n,
                  f"{name}: {launches[name]} launches on the lossy main "
                  f"path {sps_kw}, expected {want_n}")
        nbytes = 0
        for (nals, rec, st6), f in zip(coded, frames):
            check([n.nal_type for n in nals] == [8, 24],
                  f"lossy picture NALs {[n.nal_type for n in nals]}")
            for a, b in ((f.y, rec.y), (f.cb, rec.cb), (f.cr, rec.cr)):
                check(a.shape == b.shape and int(b.min()) >= 0
                      and int(b.max()) <= 255, "lossy recon out of range")
            for k in ("psnr_y", "psnr_cb", "psnr_cr"):
                check(30.0 < st6[k] < 70.0, f"{k} {st6[k]}")
            nbytes += sum(len(n.payload) + 2 for n in nals)
        psnr = {k: [round(float(c[2][k]), 4) for c in coded]
                for k in ("psnr_y", "psnr_cb", "psnr_cr")}
        return leaves, elapsed, launches, nbytes, psnr, perf.report()

    _, elapsed, launches, nbytes, psnr, phases = lossy_path(
        lossy_sps, LOSSY_LAUNCHES)
    print(f"[6] lossy main path: 2 frames 1920x1080 AI QP32 (MTS, MIP, "
          f"deblocking) on {kind}: {nbytes} bytes, {elapsed:.2f} s, "
          f"{len(frames) / elapsed:.4f} frames/s; PSNR-Y {psnr['psnr_y']} "
          f"dB; launches {launches}; phases (thread-seconds) "
          f"{json.dumps(phases)}", flush=True)

    # 7. the 2b main path (LFNST and CCLM on), two frames, counted; its
    # counts are the ones the kernel table reports
    leaves, elapsed, launches, nbytes, psnr, phases = lossy_path(
        sps_2b, LOSSY_2B_LAUNCHES)
    n_lfnst = sum(1 for l in leaves if l.lfnst)
    cm_hist = np.bincount([l.chroma_mode for l in leaves],
                          minlength=4).tolist()
    print(f"[7] 2b main path: 2 frames 1920x1080 AI QP32 (MTS, MIP, LFNST, "
          f"CCLM, deblocking) on {kind}: {nbytes} bytes, {elapsed:.2f} s, "
          f"{len(frames) / elapsed:.4f} frames/s; PSNR-Y/Cb/Cr "
          f"{psnr['psnr_y']} / {psnr['psnr_cb']} / {psnr['psnr_cr']} dB; "
          f"{len(leaves)} leaves, {n_lfnst} with LFNST, chroma modes "
          f"DM/LM/LM_L/LM_T {cm_hist}; launches {launches}; phases "
          f"(thread-seconds) {json.dumps(phases)}", flush=True)

    # 8. kernel path byte-equal to the plain path at 416x240
    small = [synth_frame(416, 240, t) for t in range(2)]
    for kw in ({}, {"num_tile_cols": 2}):
        a = encode_sequence(small, qp=32, lossless=True, **kw)[0]
        with ops.plain():
            b = encode_sequence(small, qp=32, lossless=True, **kw)[0]
        check(a == b, f"416x240 lossless {kw}: kernel stream != plain stream")
        pps = PPS(init_qp=32, num_tile_cols=kw.get("num_tile_cols", 1))
        sizes = []
        for label, sps_kw in (("2a", lossy_sps), ("2b", sps_2b)):
            sps = SPS(width=416, height=240, **sps_kw)
            a = [n.payload for poc, f in enumerate(small)
                 for n in Encoder(sps, pps).encode_frame(f, poc)[0]]
            with ops.plain():
                b = [n.payload for poc, f in enumerate(small)
                     for n in Encoder(sps, pps).encode_frame(f, poc)[0]]
            check(a == b, f"416x240 {label} {kw}: kernel stream != plain "
                  f"stream")
            sizes.append(f"{label} {sum(map(len, a))} bytes")
        print(f"[8] 416x240 {kw or 'single tile'}: lossless, "
              f"{', '.join(sizes)}: kernel streams == plain streams",
              flush=True)

    # 3 (continued). the filter statistics against their plain versions,
    # on the recon of a 2b picture (the 2b encoder of [7] again, frame 0):
    # SAO per component (Y at CTU 64, Cb and Cr at 32), ALF on luma
    rec2b = Encoder(SPS(width=W_HD, height=H_HD, **sps_2b),
                    PPS(init_qp=32)).encode_frame(frames[0], 0)[1]
    tiles = [(0, W_HD, 0, H_HD)]
    for comp, (o_np, r_np) in enumerate(zip(
            (frames[0].y, frames[0].cb, frames[0].cr),
            (rec2b.y, rec2b.cb, rec2b.cr))):
        h, w = o_np.shape
        cs = 64 >> (comp > 0)
        tl = tiles if comp == 0 else [(0, w, 0, h)]
        vx, vy = sao_enc._valid_vectors(h, w, tl)
        args = (torch.from_numpy(o_np.astype(np.int32)).to(dev),
                torch.from_numpy(r_np.astype(np.int32)).to(dev),
                torch.from_numpy(vx).to(dev), torch.from_numpy(vy).to(dev),
                cs, 8)
        got = sao.sao_stats_dev(*args)
        with ops.plain():
            want = sao.sao_stats_dev(*args)
        for g, wv in zip(got, want):
            compare("sao_stats", g.view(torch.int32), wv.view(torch.int32))
        f = lambda: sao.sao_stats_dev(*args)
        k_ms = cuda_ms(f)
        with ops.plain():
            p_ms = cuda_ms(f, iters=3, warmup=1)
        ny, nx = -(-h // cs), -(-w // cs)
        add_time("sao_stats", k_ms, p_ms,
                 2 * h * w * 4 + h + w + ny * nx * 96 * 4, 20 * h * w)
        # library: torch.bincount with weights (the sums) and without (the
        # counts) over a (CTU, category) key — 16 EO slots and 32 bands per
        # CTU, each sample keyed once per EO class (category 0 to a spare
        # bin) and once by its band; the categories are computed outside
        o_t, r_t = args[0], args[1]
        ctu = ((torch.arange(h, device=dev) // cs)[:, None] * nx
               + (torch.arange(w, device=dev) // cs)[None, :])
        spare = ny * nx * 48
        keys = []
        for ec, (dx, dy) in enumerate(sao.EO_DIRS):
            cat = torch.tensor([1, 2, 0, 3, 4], device=dev)[
                (sao._eo_signs(r_t, ec) + 2).long()]
            ok = cat > 0
            if dx:
                ok = ok & args[2][None, :]
            if dy:
                ok = ok & args[3][:, None]
            keys.append(torch.where(ok, ctu * 48 + ec * 4 + cat - 1, spare))
        keys.append(ctu * 48 + 16 + (r_t >> 3))
        key = torch.stack(keys).reshape(-1)
        wts = (o_t - r_t).to(torch.float64).reshape(-1).repeat(5)

        def lib_sao():
            return (torch.bincount(key, weights=wts, minlength=spare + 1),
                    torch.bincount(key, minlength=spare + 1))
        ld, ln = (x[:spare].reshape(ny, nx, 48).to(torch.int32)
                  for x in lib_sao())
        compare("sao_stats", ld[..., 16:], got[2].to(torch.int32))
        compare("sao_stats", ln[..., 16:], got[3].to(torch.int32))
        compare("sao_stats", ld[..., :16].reshape(ny, nx, 4, 4).permute(
            2, 3, 0, 1), got[0].to(torch.int32))
        stats["sao_stats"]["library_ms"] = (
            stats["sao_stats"]["library_ms"] or 0.0) + cuda_ms(lib_sao)
    # ALF on the 2b picture's luma (the kernel line's numbers), then on a
    # 1080p 10-bit picture where the ordered B100 walk decides (the family
    # of tests/test_torch_alf.py's test_alf_b100_bit_equal_1080p_10bit:
    # synth_frame 3 << 2 plus seeded uniform noise of ±160)
    walk_rng = np.random.default_rng(0)
    o10 = synth_frame(W_HD, H_HD, 3).y.astype(np.int32) << 2
    r10 = np.clip(o10 + walk_rng.integers(-160, 161, o10.shape), 0,
                  1023).astype(np.int32)
    sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    alf_pics = {}
    for label, o_np, r_np, bd in (("2b 8-bit", frames[0].y, rec2b.y, 8),
                                  ("10-bit walk", o10, r10, 10)):
        cls4, tr4 = alf.alf_classify(r_np, bd)
        targs = [torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)
                 for a in (o_np, r_np, cls4, tr4)]
        got = alf.alf_stats_dev(*targs)
        with ops.plain():
            want = alf.alf_stats_dev(*targs)
        for g, wv in zip(got, want):
            compare("alf_stats", g.view(torch.int32), wv.view(torch.int32))
        f = lambda: alf.alf_stats_dev(*targs)
        k_ms = cuda_ms(f)
        with ops.plain():
            p_ms = cuda_ms(f, iters=3, warmup=1)
        npts = ((H_HD + 1) // 2) * ((W_HD + 1) // 2)
        # bytes it must move: r whole, o's even rows at sector granularity,
        # cls4 and tr4, the statistics written; 90 multiply-adds per point
        nbytes = (H_HD * W_HD * 4 + (H_HD // 2) * W_HD * 4
                  + 2 * cls4.size * 4 + (100 * 90 + 50) * 8)
        # library: a float64 einsum of the one-hot [P, 100] group matrix
        # with the per-point products F·Fᵀ and F·t ([P, 156]); exact in
        # float64
        F, t, key, _ = alf._alf_grid(*targs)
        need, chain = alf_walk(alf, F, t, key)
        Ff, tf = F.to(torch.float64), t.to(torch.float64)
        prod = torch.cat([(Ff[:, None] * Ff[None, :]).reshape(144, -1),
                          Ff * tf[None]]).T.contiguous()

        def lib_alf():
            onehot = torch.nn.functional.one_hot(key, 100).to(torch.float64)
            g = torch.einsum("pg,pk->gk", onehot, prod)
            return g[:, :144].reshape(100, 12, 12), g[:, 144:]
        la, lb = lib_alf()
        compare("alf_stats", la.to(torch.float32).view(torch.int32),
                got[0].view(torch.int32))
        # B100: the entries not walked (every entry where nothing walks)
        keep = ~need
        compare("alf_stats", lb.to(torch.float32)[keep].view(torch.int32),
                got[1][keep].view(torch.int32))
        l_ms = cuda_ms(lib_alf, iters=3, warmup=1)
        b_ms, b_by = bound_ms(nbytes, npts * 2 * 92)
        alf_pics[label] = {
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": l_ms, "walked_entries": int(need.sum()),
            "longest_chain": chain}
        if label == "2b 8-bit":
            add_time("alf_stats", k_ms, p_ms, nbytes, npts * 2 * 92)
            stats["alf_stats"]["library_ms"] = l_ms
        del targs, F, t, key, Ff, tf, prod, la, lb
    for label, st in alf_pics.items():
        print(f"[3] alf_stats {label}: exact vs plain; per 1080p frame: "
              f"kernel {st['ms']:.4f} ms, plain {st['plain_ms']:.3f} ms, "
              f"bound {st['bound_ms']:.4f} ms ({st['bound_by']}), library "
              f"{st['library_ms']:.4f} ms; walk: {st['walked_entries']} "
              f"(group, row) entries, longest chain {st['longest_chain']} "
              f"points, its floor "
              f"{st['longest_chain'] * FADD_CYCLES / (sm_mhz * 1e3):.4f} "
              f"ms (an assumed {FADD_CYCLES} cycles a dependent add at the "
              f"SM's rated maximum {sm_mhz:.0f} MHz)", flush=True)
    for name in ("sao_stats", "alf_stats"):
        st = stats[name]
        st["bound_ms"], st["bound_by"] = bound_ms(st["bytes"], st["ops"])
        print(f"[3] {name}: exact vs plain; per 1080p frame (all its "
              f"launches): kernel {st['ms']:.3f} ms, plain "
              f"{st['plain_ms']:.3f} ms, bound {st['bound_ms']:.3f} ms "
              f"({st['bound_by']}), library {st['library_ms']}", flush=True)

    # 10. the slice-3 main path: lossy encode_sequence with the defaults
    # (MTS, MIP, LFNST, CCLM, deblocking, SAO, ALF, CC-ALF), two frames,
    # counted; its counts fill the kernel table
    perf.reset()
    torch.cuda.synchronize()
    ops.reset_counts()
    t0 = time.perf_counter()
    bs3, recons3, stats3 = encode_sequence(frames, qp=32)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = dict(ops.COUNTS)
    phases = perf.report()
    for name in ops.COUNTS:
        want_n = SLICE3_LAUNCHES.get(name, 0) * len(frames)
        check(launches[name] == want_n,
              f"{name}: {launches[name]} launches on the slice-3 main "
              f"path, expected {want_n}")
    nals3 = read_annexb(bs3)
    types = [n.nal_type for n in nals3]
    check(types[:2] == [15, 16] and types[2:].count(8) == len(frames)
          and types[2:].count(24) == len(frames)
          and set(types[2:]) <= {8, 17, 24},
          f"slice-3 stream NAL types {types}")
    for f, r, st3 in zip(frames, recons3, stats3):
        for a, b in ((f.y, r.y), (f.cb, r.cb), (f.cr, r.cr)):
            check(a.shape == b.shape and int(b.min()) >= 0
                  and int(b.max()) <= 255, "slice-3 recon out of range")
        for k in ("psnr_y", "psnr_cb", "psnr_cr"):
            check(30.0 < st3[k] < 70.0, f"slice 3 {k} {st3[k]}")
        check("sao_types" in st3 and "alf" in st3,
              "slice-3 stats lack the SAO/ALF record")
    with ops.plain():
        bs3_plain = encode_sequence(frames, qp=32)[0]
    check(bs3 == bs3_plain, "1080p slice-3 stream: kernels != plain")
    sao_hist = np.sum([s3["sao_types"] for s3 in stats3], axis=0).tolist()
    print(f"[10] slice-3 main path: 2 frames 1920x1080 AI QP32 "
          f"(encode_sequence defaults: MTS, MIP, LFNST, CCLM, deblocking, "
          f"SAO, ALF, CC-ALF) on {kind}: {len(bs3)} bytes, {elapsed:.2f} s, "
          f"{len(frames) / elapsed:.4f} frames/s; PSNR-Y/Cb/Cr "
          f"{[round(float(s3['psnr_y']), 4) for s3 in stats3]} / "
          f"{[round(float(s3['psnr_cb']), 4) for s3 in stats3]} / "
          f"{[round(float(s3['psnr_cr']), 4) for s3 in stats3]} dB; "
          f"NAL types {types}; SAO CTUs (OFF, BO, EO) for Y/Cb/Cr "
          f"{sao_hist}; ALF {[s3['alf'] for s3 in stats3]}; stream == "
          f"plain stream; launches {launches}; phases (thread-seconds) "
          f"{json.dumps(phases)}", flush=True)

    # 11. bench_ai's configuration: 8 frames 416x240 QP32, the defaults
    bench = [synth_frame(416, 240, t) for t in range(8)]
    for kw in ({}, {"num_tile_cols": 2}):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a = encode_sequence(bench, qp=32, **kw)[0]
        torch.cuda.synchronize()
        el = time.perf_counter() - t0
        with ops.plain():
            b = encode_sequence(bench, qp=32, **kw)[0]
        check(a == b, f"416x240x8 {kw}: kernel stream != plain stream")
        print(f"[11] bench_ai 8 frames 416x240 QP32 {kw or 'single tile'} "
              f"on {kind}: {len(a)} bytes, {el:.2f} s, "
              f"{len(bench) / el:.4f} frames/s; kernel stream == plain "
              f"stream", flush=True)

    # 12. the slice-4a main path: Random Access, GOP 8, 9 frames of the
    # motion clip at 1080p, vvc's defaults; its counts fill the kernel
    # table
    clip9 = motion_clip(9, W_HD, H_HD)
    perf.reset()
    torch.cuda.synchronize()
    ops.reset_counts()
    t0 = time.perf_counter()
    bs12, recons12, stats12 = encode_sequence(clip9, qp=32, mode="ra",
                                              gop_size=8)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = dict(ops.COUNTS)
    phases = perf.report()
    for name in ops.COUNTS:
        check((launches[name] > 0) == (name not in RECT_KERNELS + KERNELS_4B
                                       + KERNELS_DEC + KERNELS_SHARD
                                       + KERNELS_R4),
              f"{name}: {launches[name]} launches on the slice-4a main "
              f"path")
    nals12 = read_annexb(bs12)
    types = [n.nal_type for n in nals12]
    slice_nals = [n for n in nals12 if n.nal_type in (0, 8)]
    check(types[:2] == [15, 16] and len(slice_nals) == len(clip9)
          and types[2:].count(24) == len(clip9)
          and set(types[2:]) <= {0, 8, 17, 24},
          f"slice-4a stream NAL types {types}")
    order_types = [(s12["poc"], s12["slice_type"]) for s12 in stats12]
    check([st for _, st in order_types] == [2, 0, 0, 0, 0, 0, 0, 0, 1],
          f"slice types by POC {order_types}")
    check([n.nal_type for n in slice_nals].count(8) == 1,
          "one IDR picture expected")
    dirs = np.sum([s12["leaf_dirs"] for s12 in stats12[1:]], axis=0)
    for f, r, s12 in zip(clip9, recons12, stats12):
        for a, b in ((f.y, r.y), (f.cb, r.cb), (f.cr, r.cr)):
            check(a.shape == b.shape and int(b.min()) >= 0
                  and int(b.max()) <= 255, "slice-4a recon out of range")
        for k in ("psnr_y", "psnr_cb", "psnr_cr"):
            check(30.0 < s12[k] < 70.0, f"slice 4a POC {s12['poc']} {k} "
                  f"{s12[k]}")
    check(20000 < len(bs12) < 9 * 250000,
          f"slice-4a stream {len(bs12)} bytes")
    check(dirs[1:].sum() > 0 and dirs[3] > 0,
          f"inter leaves by dir {dirs.tolist()}")
    print(f"[12] slice-4a main path: 9 frames 1920x1080 RA GOP8 QP32 "
          f"(encode_sequence defaults, motion clip) on {kind}: "
          f"{len(bs12)} bytes, {elapsed:.2f} s, "
          f"{len(clip9) / elapsed:.4f} frames/s; (POC, slice type) "
          f"{order_types}; NAL types {types}; PSNR-Y/Cb/Cr by POC "
          f"{[round(float(s12['psnr_y']), 4) for s12 in stats12]} / "
          f"{[round(float(s12['psnr_cb']), 4) for s12 in stats12]} / "
          f"{[round(float(s12['psnr_cr']), 4) for s12 in stats12]} dB; "
          f"bytes by POC {[s12['bits'] // 8 for s12 in stats12]}; "
          f"leaves of the P/B pictures (intra, L0, L1, bi) {dirs.tolist()} "
          f"({100.0 * dirs[1:].sum() / dirs.sum():.2f} % inter); launches "
          f"{launches}; phases (thread-seconds) {json.dumps(phases)}",
          flush=True)

    # 13. kernel path byte-equal to the plain path at 416x240, inter GOPs
    clip_s = motion_clip(9, 416, 240)
    for mode, n, kw in (("ldp", 4, {}), ("ldb", 4, {}),
                        ("ra", 9, {"gop_size": 8})):
        t0 = time.perf_counter()
        a = encode_sequence(clip_s[:n], qp=32, mode=mode, **kw)[0]
        el = time.perf_counter() - t0
        with ops.plain():
            b = encode_sequence(clip_s[:n], qp=32, mode=mode, **kw)[0]
        check(a == b, f"416x240 {mode} {n} frames: kernel stream != plain "
              f"stream")
        print(f"[13] 416x240 {mode.upper()} {n} frames {kw}: {len(a)} bytes, "
              f"{el:.2f} s; kernel stream == plain stream", flush=True)
    launches12 = launches

    # 14. the slice-2c main path: 2 frames 1080p All-Intra through
    # encode_sequence with the MTT lattice, ISP, MRL and dependent
    # quantization; its counts fill the table for the rect kernels
    check(rdo._candidate_shapes(64, 8, True) == MTT_SHAPES,
          "the MTT lattice differs from MTT_SHAPES")
    kw2c = dict(qp=32, mtt=True, isp=True, mrl=True, dep_quant=True)
    perf.reset()
    torch.cuda.synchronize()
    ops.reset_counts()
    t0 = time.perf_counter()
    bs14, recons14, stats14 = encode_sequence(frames, **kw2c)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches14 = dict(ops.COUNTS)
    phases = perf.report()
    for name in ops.COUNTS:
        check((launches14[name] > 0) == (name not in ME_KERNELS + KERNELS_4B
                                         + KERNELS_DEC + KERNELS_SHARD
                                         + KERNELS_R4),
              f"{name}: {launches14[name]} launches on the slice-2c main "
              f"path")
    types = [n.nal_type for n in read_annexb(bs14)]
    check(types[:2] == [15, 16] and types[2:].count(8) == len(frames)
          and set(types[2:]) <= {8, 17, 24}, f"slice-2c NAL types {types}")
    for f, r, s14 in zip(frames, recons14, stats14):
        for a, b in ((f.y, r.y), (f.cb, r.cb), (f.cr, r.cr)):
            check(a.shape == b.shape and int(b.min()) >= 0
                  and int(b.max()) <= 255, "slice-2c recon out of range")
        for k in ("psnr_y", "psnr_cb", "psnr_cr"):
            check(30.0 < s14[k] < 70.0, f"slice 2c {k} {s14[k]}")
    check(20000 < len(bs14) < 2 * 600000, f"slice-2c stream {len(bs14)} "
          f"bytes")
    kinds = [s14["leaf_kinds"] for s14 in stats14]
    for k in ("rect", "tt_mid", "isp", "mrl"):
        check(sum(kd[k] for kd in kinds) > 0, f"no {k} leaf on the 2c path")
    shapes14 = {}
    for kd in kinds:
        for k, v in kd["shapes"].items():
            shapes14[k] = shapes14.get(k, 0) + v
    # the search alone: kernels against the plain path, and its time
    v14 = torch.from_numpy(rdo.pack_planes(frames[0].y, frames[0].cb,
                                           frames[0].cr)).to(dev)
    search = lambda: rdo.eval_all_sizes(v14, MTT_SHAPES, 32, 8, W_HD, H_HD,
                                        False, True, True, True)
    got = search()
    with ops.plain():
        want = search()
    check(torch.equal(got, want), "1080p MTT + ISP search vector: kernels "
          "!= plain")
    search_ms = cuda_ms(search, iters=3, warmup=1)
    with ops.plain():
        search_plain_ms = cuda_ms(search, iters=1, warmup=0)
    del got, want
    print(f"[14] slice-2c main path: 2 frames 1920x1080 AI QP32 "
          f"(encode_sequence defaults + mtt, isp, mrl, dep_quant) on {kind}: "
          f"{len(bs14)} bytes, {elapsed:.2f} s, "
          f"{len(frames) / elapsed:.4f} frames/s; PSNR-Y/Cb/Cr "
          f"{[round(float(x['psnr_y']), 4) for x in stats14]} / "
          f"{[round(float(x['psnr_cb']), 4) for x in stats14]} / "
          f"{[round(float(x['psnr_cr']), 4) for x in stats14]} dB; leaves "
          f"{[x['n_cu'] for x in stats14]}: rect "
          f"{[kd['rect'] for kd in kinds]}, TT mid "
          f"{[kd['tt_mid'] for kd in kinds]}, ISP "
          f"{[kd['isp'] for kd in kinds]}, MRL {[kd['mrl'] for kd in kinds]};"
          f" by shape {json.dumps(dict(sorted(shapes14.items())))}; one "
          f"frame's search {search_ms:.3f} ms (plain "
          f"{search_plain_ms:.3f} ms), vector == plain; launches "
          f"{launches14}; phases (thread-seconds) {json.dumps(phases)}",
          flush=True)

    # 15. kernel path byte-equal to the plain path at 416x240 with the
    # slice-2c tools, single tile and 2 tile columns
    for cols in (1, 2):
        t0 = time.perf_counter()
        a = encode_sequence(small, num_tile_cols=cols, **kw2c)[0]
        el = time.perf_counter() - t0
        with ops.plain():
            b = encode_sequence(small, num_tile_cols=cols, **kw2c)[0]
        check(a == b, f"416x240 2c {cols} tile column(s): kernel stream != "
              f"plain stream")
        print(f"[15] 416x240 2 frames mtt+isp+mrl+dep_quant, {cols} tile "
              f"column(s): {len(a)} bytes, {el:.2f} s; kernel stream == "
              f"plain stream", flush=True)
    # 16. the slice-4b main path: Random Access (N_4B frames, GOP_4B) at
    # 1080p with bench_ra1080's tool set but LMCS, on the tool clip; its
    # counts fill the table for the three 4b kernels
    clip16 = tool_frames(N_4B, W_HD, H_HD)
    perf.reset()
    torch.cuda.synchronize()
    ops.reset_counts()
    t0 = time.perf_counter()
    bs16, recons16, stats16 = encode_sequence(clip16, qp=32, mode="ra",
                                              gop_size=GOP_4B,
                                              **RA1080_TOOLS)
    torch.cuda.synchronize()
    elapsed16 = time.perf_counter() - t0
    launches16 = dict(ops.COUNTS)
    phases16 = perf.report()
    for name in ops.COUNTS:
        check((launches16[name] > 0) == (name not in KERNELS_DEC
                                         + KERNELS_SHARD + KERNELS_R4),
              f"{name}: {launches16[name]} launches on the slice-4b main "
              f"path")
    nals16 = read_annexb(bs16)
    types = [n.nal_type for n in nals16]
    slice_nals = [n for n in nals16 if n.nal_type in (0, 8)]
    check(types[:2] == [15, 16] and len(slice_nals) == len(clip16)
          and types[2:].count(24) == len(clip16)
          and set(types[2:]) <= {0, 8, 17, 24},
          f"slice-4b stream NAL types {types}")
    order16 = [s16["slice_type"] for s16 in stats16]
    check(order16[0] == 2 and order16[-1] == 1
          and set(order16[1:-1]) == {0}, f"slice types by POC {order16}")
    for f, r, s16 in zip(clip16, recons16, stats16):
        for a, b in ((f.y, r.y), (f.cb, r.cb), (f.cr, r.cr)):
            check(a.shape == b.shape and int(b.min()) >= 0
                  and int(b.max()) <= 255, "slice-4b recon out of range")
        # the clip's chroma is flat: its PSNR may be infinite
        for k, hi in (("psnr_y", 70.0), ("psnr_cb", float("inf")),
                      ("psnr_cr", float("inf"))):
            check(25.0 < s16[k] <= hi, f"slice 4b POC {s16['poc']} {k} "
                  f"{s16[k]}")
    check(10000 < len(bs16) < len(clip16) * 600000,
          f"slice-4b stream {len(bs16)} bytes")
    tools16 = {}
    for s16 in stats16:
        for k, v in s16.get("inter_tools", {}).items():
            tools16[k] = tools16.get(k, 0) + v
    check(tools16.get("affine", 0) > 0, f"no affine leaf on the 4b path: "
          f"{tools16}")
    check(phases16.get("mctf", {}).get("n", 0) > 0, "MCTF did not run")
    print(f"[16] slice-4b main path: {len(clip16)} frames 1920x1080 RA "
          f"GOP{GOP_4B} QP32 (encode_sequence with {sorted(RA1080_TOOLS)}, "
          f"tool clip) on {kind}: {len(bs16)} bytes, {elapsed16:.2f} s, "
          f"{len(clip16) / elapsed16:.4f} frames/s; slice types by POC "
          f"{order16}; PSNR-Y by POC "
          f"{[round(float(x['psnr_y']), 4) for x in stats16]} dB; bytes by "
          f"POC {[x['bits'] // 8 for x in stats16]}; leaves per tool "
          f"{json.dumps(tools16)}; launches {launches16}; phases "
          f"(thread-seconds) {json.dumps(phases16)}", flush=True)

    # 17. kernel path byte-equal to the plain path at 416x240 with the
    # slice-4b tools: LDP with affine (3 frames), RA GOP 4 with the ten
    # options (5 frames)
    clip_t = tool_frames(5, 416, 240)
    for mode, n, kw in (("ldp", 3, {"affine": True}),
                        ("ra", 5, dict(TOOLS_4B, gop_size=4))):
        t0 = time.perf_counter()
        a = encode_sequence(clip_t[:n], qp=32, mode=mode, **kw)[0]
        el = time.perf_counter() - t0
        with ops.plain():
            b = encode_sequence(clip_t[:n], qp=32, mode=mode, **kw)[0]
        check(a == b, f"416x240 4b {mode} {n} frames: kernel stream != "
              f"plain stream")
        print(f"[17] 416x240 {mode.upper()} {n} frames {sorted(kw)}: "
              f"{len(a)} bytes, {el:.2f} s; kernel stream == plain stream",
              flush=True)
    # 19-21. the decoder
    launches20 = decoder_phases(
        ops, stats, compare, kind, frames, bs3, recons3,
        ((12, bs12, recons12), (14, bs14, recons14), (16, bs16, recons16)),
        encode_sequence)
    # 22-26. slice 6: the sharded encode, the halo deblock, DCN, the CLIs
    launches24 = shard_phases(ops, stats, compare, kind, encode_sequence)
    # 27-28. slice 7: the r4 engine, the Gauss-Newton affine ME, SSE/SAD,
    # eval_ref; sharded_rdo_step on the card
    launches27 = r4_phases(ops, stats, compare, kind)
    print(f"[29] all phases passed in {time.perf_counter() - t_start:.1f} s",
          flush=True)

    rep = {"ref_lines": "vvc/enc/rdo.py:59",
           "intra_pred_all": "vvc/kernels/intra.py:671",
           "satd": "vvc/kernels/satd.py:37",
           "transform_fwd": "vvc/kernels/transform.py:78",
           "transform_inv": "vvc/kernels/transform.py:94",
           "quant_rate": "vvc/kernels/quant.py:87,106; "
                         "vvc/cabac/rates.py:41",
           "mip_pred_all": "vvc/kernels/mip.py:112",
           "lfnst_fwd": "vvc/kernels/lfnst.py:94",
           "lfnst_inv": "vvc/kernels/lfnst.py:109",
           "luma_ds": "vvc/kernels/cclm.py:173",
           "cclm_models": "vvc/kernels/cclm.py:187",
           "intra_pred_one": "vvc/kernels/intra.py:878",
           "sao_stats": "vvc/kernels/sao.py:157",
           "alf_stats": "vvc/kernels/alf.py:330",
           "me_prep": "vvc/enc/me.py:73",
           "me_coarse": "vvc/enc/me.py:108",
           "me_int": "vvc/enc/me.py:150,156,167",
           "me_qpel": "vvc/enc/me.py:203",
           "ref_lines_rect": "vvc/enc/rdo.py:86",
           "intra_pred_all_rect": "vvc/kernels/intra.py:799",
           "intra_pred_one_rect": "vvc/kernels/intra.py:822",
           "affine_search": "vvc/enc/me.py:272",
           "affine_dctif": "vvc/enc/me.py:374",
           "me_block_err": "vvc/enc/me.py:423",
           "wave_ref_lines": "vvc/dec/wavefront.py:78-82; "
                             "vvc/kernels/intra.py:147",
           "dequant": "vvc/kernels/quant.py:106",
           "wave_cclm": "vvc/dec/wavefront.py:100-104; "
                        "vvc/kernels/cclm.py:232",
           "wave_commit": "vvc/dec/wavefront.py:111-114,134-138",
           "tile_edge_deblock": "vvc/shard/filter.py:35,101 (shard body "
                                ":119-131)",
           "interp_planes": "vvc/kernels/mc.py:438 (body :456)",
           "phase_gather": "vvc/kernels/mc.py:482",
           "block_dist": "vvc/kernels/satd.py:26,33; "
                         "vvc/enc/inter_search.py:391 (err)",
           "me_full": "vvc/enc/inter_search.py:70",
           "affine_gn": "vvc/kernels/affine.py:253,295"}
    # launches: the rect kernels' from the slice-2c path [14], the 4b
    # kernels' from the slice-4b path [16], the decoder's from the
    # wavefront decode [20], tile_edge_deblock's from the 4-rank deblock
    # [24], slice 7's from its path [27], the others' from the slice-4a
    # path [12]
    table = [{"name": k, "route": "cuda",
              "source": f"vvc_torch/csrc/{ops.SOURCES[k]}",
              "replaces": rep[k],
              "launches": (launches14 if k in RECT_KERNELS
                           else launches16 if k in KERNELS_4B
                           else launches20 if k in KERNELS_DEC
                           else {k: launches24} if k in KERNELS_SHARD
                           else launches27 if k in KERNELS_R4
                           else launches12)[k],
              "max_abs_err": stats[k]["max_abs_err"], "ms": stats[k]["ms"],
              "plain_ms": stats[k]["plain_ms"],
              "bound_ms": stats[k]["bound_ms"],
              "bound_by": stats[k]["bound_by"],
              "library_ms": stats[k]["library_ms"]} for k in ops.COUNTS]
    for row in table:
        if row["name"] == "alf_stats":
            row["pictures"] = alf_pics
        if row["name"] in rect:
            r = rect[row["name"]]
            row["rect"] = {"launches": launches14[row["name"]],
                           **{k: r[k] for k in ("ms", "plain_ms", "bound_ms",
                                                "bound_by", "library_ms")}}
    print(json.dumps({"kernels": table}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Multi-host (DCN) encode: GOP-segment scatter across processes.

Port of vvc/shard/dcn.py.  The sequence splits into GOP-aligned,
IDR-delimited segments; each process (its own Python interpreter, torch
runtime and, in production, its own card or host) encodes its segment
independently with encode_sequence(poc_base=...), so slice headers carry
global POCs, and the parent gathers the segment bitstreams into one stream
with the parcat concatenator (vvc_torch.cli.parcat).  Segments share
nothing, so no collective is needed on this axis; a segment's interior may
use the (frame × tile) mesh (vvc_torch.shard.encode).

Children are spawned (never forked: the parent may hold a CUDA context)
and receive their device in their arguments: the card, or "cpu".  The
parent builds the CUDA kernels and the native cores before it spawns, so
the children only load them from vvc_torch/_build/ (the builds' locks are
per process).  Each child returns its kernel launch counts (ops.COUNTS)
with its result, so the parent can show that the kernels ran.
"""
from __future__ import annotations

import multiprocessing as mp

import numpy as np
import torch

from vvc_torch import ops


def split_segments(n_frames: int, n_hosts: int, gop_size: int = 16):
    """[(start, count), ...] — GOP-aligned, near-equal segments."""
    n_gops = max(1, -(-n_frames // gop_size))
    n_hosts = min(n_hosts, n_gops)
    out = []
    start = 0
    for h in range(n_hosts):
        gops = n_gops // n_hosts + (1 if h < n_gops % n_hosts else 0)
        count = min(gops * gop_size, n_frames - start)
        if count <= 0:
            break
        out.append((start, count))
        start += count
    return out


def _encode_segment(args):
    """Worker (child process, or in-process): encode one IDR-delimited
    segment on ``device``.  Returns (start, bitstream, recon plane bytes,
    stats, kernel launch counts of this segment)."""
    (start, yuv, shape, bit_depth, kwargs, device) = args
    from vvc_torch.enc.encoder import encode_sequence
    from vvc_torch.io.yuv import Frame
    n, h, w = shape
    # writable copies: torch.from_numpy warns on read-only buffers
    ys = np.frombuffer(yuv[0], np.int32).reshape(n, h, w).copy()
    cbs = np.frombuffer(yuv[1], np.int32).reshape(n, h // 2, w // 2).copy()
    crs = np.frombuffer(yuv[2], np.int32).reshape(n, h // 2, w // 2).copy()
    frames = [Frame(ys[i], cbs[i], crs[i], bit_depth) for i in range(n)]
    before = dict(ops.COUNTS)
    bs, recons, stats = encode_sequence(frames, bit_depth=bit_depth,
                                        poc_base=start, device=device,
                                        **kwargs)
    counts = {k: ops.COUNTS[k] - before[k] for k in ops.COUNTS}
    return (start, bs,
            [(np.ascontiguousarray(r.y).tobytes(),
              np.ascontiguousarray(r.cb).tobytes(),
              np.ascontiguousarray(r.cr).tobytes()) for r in recons],
            stats, counts)


def _init_child(threads):
    if threads is not None:
        torch.set_num_threads(threads)


def encode_multihost(frames, n_hosts: int = 2, gop_size: int = 16,
                     processes: bool = True, device=None,
                     return_counts: bool = False,
                     timeout_s: float = 3600.0, threads: int | None = None,
                     **kwargs):
    """Encode ``frames`` across n_hosts processes → (annexb, recons, stats)
    (and, with return_counts, the kernel launch counts of each segment).

    processes=False runs the segments in-process (same code path, no
    spawn) — the two must be byte-identical, which is the determinism
    proof the multi-host story rests on.  device: None = CUDA, "cpu" =
    the plain path; every segment runs on it.  timeout_s: the
    children must all be done within it, else they are terminated and
    multiprocessing.TimeoutError is raised; threads: torch's thread count
    in each child (None: torch's default)."""
    from vvc_torch.cli.parcat import concat
    from vvc_torch.io.yuv import Frame
    h, w = frames[0].y.shape
    bit_depth = frames[0].bit_depth
    segs = split_segments(len(frames), n_hosts, gop_size)
    dev = str(ops.resolve_device(device))
    kwargs = dict(kwargs)
    kwargs.setdefault("gop_size", gop_size)
    jobs = []
    for start, count in segs:
        sub = frames[start:start + count]
        yuv = (b"".join(np.ascontiguousarray(f.y, np.int32).tobytes()
                        for f in sub),
               b"".join(np.ascontiguousarray(f.cb, np.int32).tobytes()
                        for f in sub),
               b"".join(np.ascontiguousarray(f.cr, np.int32).tobytes()
                        for f in sub))
        jobs.append((start, yuv, (count, h, w), bit_depth, kwargs, dev))
    if processes and len(jobs) > 1:
        from vvc_torch import packer
        if dev != "cpu":
            ops.build()
        packer.lib()
        packer.recon_lib()
        ctx = mp.get_context("spawn")
        with ctx.Pool(len(jobs), initializer=_init_child,
                      initargs=(threads,)) as pool:
            results = pool.map_async(_encode_segment, jobs,
                                     chunksize=1).get(timeout_s)
    else:
        results = [_encode_segment(j) for j in jobs]
    results.sort(key=lambda r: r[0])
    bitstream = concat([r[1] for r in results])
    recons = []
    stats = []
    for (_, _, recs, sts, _) in results:
        for (yb, cbb, crb) in recs:
            recons.append(Frame(
                np.frombuffer(yb, np.int32).reshape(h, w).copy(),
                np.frombuffer(cbb, np.int32).reshape(h // 2, w // 2).copy(),
                np.frombuffer(crb, np.int32).reshape(h // 2, w // 2).copy(),
                bit_depth))
        stats.extend(sts)
    if return_counts:
        return bitstream, recons, stats, [r[4] for r in results]
    return bitstream, recons, stats

"""vvc_torch stands alone: after importing it and running tiny CPU
encodes — lossless encode_sequence, a lossy Encoder.encode_frame with
MTS, MIP and deblocking, one with LFNST and CCLM too, a lossy
encode_sequence with the default tool set (SAO, ALF and CC-ALF on), one
with MTT and ISP (and MRL and dependent quantization) too, inter
encode_sequence in LDP and RA, and RA with the ten slice-4b options
(affine, MCTF, BDOF, DMVR, MMVD, CIIP, GPM, AMVR, SMVD, BCW), then
decoding the lossless and the lossy stream with the port's decode_stream
on the host path and the wavefront path, a sharded encode on 2 gloo ranks
(vvc_torch.shard), a DCN encode and the CLIs' encode → decode round trip
(vvc_torch.cli), and slice 7's functions (the r4 engine's phase planes,
gather and me_pred_program, sse_batch / sad_batch, the Gauss-Newton
affine ME, eval_ref) — no JAX module and no module of the JAX package
`vvc` is loaded, in the process or in a rank; and the entry points, given no
device, ask for CUDA and raise where CUDA is absent instead of falling
back to the CPU."""
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import json, sys
import torch
import vvc_torch
from vvc_torch.enc.encoder import Encoder, encode_sequence
from vvc_torch.hls.ps import PPS, SPS
from vvc_torch.io.synth import synth_frame
from vvc_torch import ops
frames = [synth_frame(64, 64, t) for t in range(2)]
bs, recons, _ = encode_sequence(frames, qp=32, lossless=True, device="cpu")
ok = all((f.y == r.y).all() for f, r in zip(frames, recons))
sps = SPS(width=64, height=64, deblocking=True, mts_intra=True, mip=True)
nals, rec, stats = Encoder(sps, PPS(init_qp=32), device="cpu").encode_frame(
    frames[0], 0)
lossy_ok = bool(len(nals) == 2 and 20 < stats["psnr_y"] < 60)
sps2b = SPS(width=64, height=64, deblocking=True, mts_intra=True, mip=True,
            lfnst=True, cclm=True)
nals, rec, stats = Encoder(sps2b, PPS(init_qp=32),
                           device="cpu").encode_frame(frames[1], 1)
lossy_ok = lossy_ok and bool(len(nals) == 2 and 20 < stats["psnr_y"] < 60)
bs3, _, stats3 = encode_sequence(frames, qp=32, device="cpu")
lossy_ok = lossy_ok and bool(len(bs3) > 0 and all(
    "alf" in s and "sao_types" in s for s in stats3))
from vvc_torch.io.synth import motion_clip
clip = motion_clip(5, 64, 64)
bs4, _, stats4 = encode_sequence(clip[:3], qp=32, mode="ldp", device="cpu")
bs5, _, stats5 = encode_sequence(clip, qp=32, mode="ra", gop_size=4,
                                 device="cpu")
bs6, _, stats6 = encode_sequence(frames, qp=32, mtt=True, isp=True,
                                 device="cpu")
bs7, _, _ = encode_sequence(frames[:1], qp=32, mtt=True, isp=True, mrl=True,
                            dep_quant=True, device="cpu")
lossy_ok = lossy_ok and bool(len(bs6) > 0 and len(bs7) > 0)
tools4b = dict(affine=True, mctf=True, bdof=True, dmvr=True, mmvd=True,
               ciip=True, gpm=True, amvr=True, smvd=True, bcw=True)
bs8, _, stats8 = encode_sequence(clip, qp=32, mode="ra", gop_size=4,
                                 device="cpu", **tools4b)
ok4b = bool(len(bs8) > 0 and all("inter_tools" in s for s in stats8
                                 if s["slice_type"] != 2))
inter_ok = bool(len(bs4) > 0 and len(bs5) > 0
                and [s["slice_type"] for s in stats4] == [2, 1, 1]
                and [s["slice_type"] for s in stats5] == [2, 0, 0, 0, 1])
from vvc_torch.dec.decoder import decode_stream
dec_ok = True
for data, n in ((bs, 2), (bs3, 2)):
    host, info = decode_stream(data, device="cpu")
    wave, info_w = decode_stream(data, wavefront=True, device="cpu")
    dec_ok = dec_ok and info["hash_ok"] == info_w["hash_ok"] == [True] * n
    dec_ok = dec_ok and all((a == b).all() for f, g in zip(host, wave)
                            for a, b in zip(f.planes(), g.planes()))
dec_ok = dec_ok and all((f.y == d.y).all() for f, d in zip(
    frames, decode_stream(bs, device="cpu")[0]))
import os, tempfile
import vvc_torch.shard.dcn, vvc_torch.shard.encode, vvc_torch.shard.filter
import vvc_torch.shard.halo, vvc_torch.shard.launch, vvc_torch.shard.mesh
from vvc_torch.cli import cfg, parcat, vvcdec, vvcenc
from vvc_torch.io.yuv import YuvWriter
from vvc_torch.shard.dcn import encode_multihost
from vvc_torch.shard.launch import run_ranks
from tests import torch_ranks
(bs9, _, _), rank_mods = run_ranks(torch_ranks.encode_and_modules, 2, "gloo",
                                   "cpu", 240, frames, qp=32,
                                   num_tile_cols=1, threads=1)
bs10, _, _ = encode_multihost(frames, n_hosts=2, gop_size=1,
                              processes=False, device="cpu", qp=32)
tmp = tempfile.mkdtemp()
with YuvWriter(os.path.join(tmp, "in.yuv")) as wr:
    for f in frames:
        wr.write_frame(f)
enc_args = ["-i", os.path.join(tmp, "in.yuv"), "-wdt", "64", "-hgt", "64",
            "-f", "2", "-q", "32", "-b", os.path.join(tmp, "out.266"),
            "-o", os.path.join(tmp, "rec.yuv")]
dec_args = ["-b", os.path.join(tmp, "out.266"),
            "-o", os.path.join(tmp, "dec.yuv")]
import contextlib, io
with contextlib.redirect_stdout(io.StringIO()):
    vvcenc.main(enc_args, device="cpu")
    vvcdec.main(dec_args, device="cpu")
shard_ok = bool(rank_mods == [] and bs9 == bs3 and bs10 == bs3 and open(
    os.path.join(tmp, "dec.yuv"), "rb").read() == open(
    os.path.join(tmp, "rec.yuv"), "rb").read())
import numpy as np
from vvc_torch.enc import inter_search, me
from vvc_torch.kernels import affine, mc, satd
lam = np.float32(3.7)
cur_t = torch.from_numpy(clip[1].y.astype(np.int32))
ref_t = torch.from_numpy(clip[0].y.astype(np.int32))
phase = mc.interp_luma_planes(ref_t, 8)
plane_r4, err_r4 = inter_search.me_pred_program(cur_t, phase, 16, 8, 64, 64,
                                                lam)
blk = me.raster_blocks(cur_t, 4, 4, 16)
gx = torch.arange(4, dtype=torch.int32).repeat(4) * 16
gy = torch.arange(4, dtype=torch.int32).repeat_interleave(4) * 16
z = torch.zeros(16, dtype=torch.int32)
pred_r4 = mc.gather_pred_planes(phase, gx, gy, z + 5, z - 3, 16)
sse_r4, sad_r4 = satd.sse_batch(pred_r4, blk), satd.sad_batch(pred_r4, blk)
cp_r4 = affine.affine_me_batch(blk.float(), ref_t.float(), gx, gy, z, z, 16,
                               8)
ev_r4 = me.eval_ref(me.prep_ref(ref_t)[0], blk, gy, gx, z, z, lam, 16, 64,
                    64, 8)
r4_ok = bool(plane_r4.shape == (64, 64) and err_r4.shape == (4, 4)
             and sse_r4.shape == sad_r4.shape == (16,)
             and cp_r4.shape == (16, 3, 2) and ev_r4["pred"].shape
             == (16, 16, 16))
raised = []
if not torch.cuda.is_available():
    for call in (lambda: encode_sequence(frames, qp=32, lossless=True),
                 lambda: encode_sequence(frames, qp=32),
                 lambda: encode_sequence(clip[:2], qp=32, mode="ldp"),
                 lambda: encode_sequence(frames, qp=32, mtt=True, isp=True),
                 lambda: encode_sequence(clip[:2], qp=32, mode="ldp",
                                         affine=True),
                 lambda: Encoder(sps, PPS(init_qp=32)),
                 lambda: decode_stream(bs3, wavefront=True),
                 lambda: encode_multihost(frames, n_hosts=2, gop_size=1,
                                          processes=False),
                 lambda: vvcenc.main(enc_args),
                 lambda: vvcdec.main(dec_args)):
        try:
            call()
        except RuntimeError as e:
            raised.append(str(e))
import shutil
shutil.rmtree(tmp)
print(json.dumps({
    "mods": sorted(m for m in sys.modules
                   if m.split(".")[0] in ("jax", "jaxlib", "vvc")),
    "bytes": len(bs), "ok": ok, "lossy_ok": lossy_ok,
    "inter_ok": inter_ok, "ok4b": ok4b, "dec_ok": dec_ok,
    "shard_ok": shard_ok, "r4_ok": r4_ok,
    "raised": raised,
    "counts": ops.COUNTS, "cuda": torch.cuda.is_available()}))
"""


def test_port_imports_no_jax_and_no_vvc():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout
    res = json.loads(out.strip().splitlines()[-1])
    assert res["mods"] == []
    assert res["ok"] and res["bytes"] > 0 and res["lossy_ok"]
    assert res["inter_ok"] and res["ok4b"] and res["dec_ok"]
    assert res["shard_ok"] and res["r4_ok"]
    # CPU tensors take the plain versions: no kernel launch is counted
    assert res["counts"] == {k: 0 for k in (
        "ref_lines", "intra_pred_all", "satd", "transform_fwd",
        "transform_inv", "quant_rate", "mip_pred_all", "lfnst_fwd",
        "lfnst_inv", "luma_ds", "cclm_models", "intra_pred_one",
        "sao_stats", "alf_stats", "me_prep", "me_coarse", "me_int",
        "me_qpel", "ref_lines_rect", "intra_pred_all_rect",
        "intra_pred_one_rect", "affine_search", "affine_dctif",
        "me_block_err", "wave_ref_lines", "dequant", "wave_cclm",
        "wave_commit", "tile_edge_deblock", "interp_planes", "phase_gather",
        "block_dist", "me_full", "affine_gn")}
    if not res["cuda"]:
        assert len(res["raised"]) == 10
        assert all("CUDA is not available" in r for r in res["raised"])

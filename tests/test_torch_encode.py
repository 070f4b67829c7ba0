"""The port's encoder (vvc_torch.enc.encoder) against vvc's: lossless
All-Intra streams (encode_sequence), lossy All-Intra pictures with MTS,
MIP and deblocking (Encoder.encode_frame; slice 2b adds LFNST and CCLM),
and lossy encode_sequence with vvc's default tool set (slice 3 adds SAO,
ALF and CC-ALF) are byte-equal, single-tile and with 2 tile columns, the
reconstructions are equal, and vvc's decoder decodes them with every
picture hash OK.  Options of later slices (LMCS and WPP: slice 2d, also
in Random Access) raise;
MTT, ISP, MRL and dependent quantization are tests/test_torch_mtt.py's.
Tolerance: exact (bytes and samples)."""
import numpy as np
import pytest

from vvc.common.types import NalUnitType
from vvc.dec.decoder import decode_stream
from vvc.enc.encoder import Encoder as RefEncoder
from vvc.enc.encoder import encode_sequence as ref_encode
from vvc.hls.ps import PPS, SPS
from vvc.hls.write import write_pps, write_sps
from vvc.io.nal import NalUnit, write_annexb
from vvc.io.synth import synth_frame

from tests.test_torch_rdo import (  # noqa: F401
    _one_torch_thread, release_jax_programs)

# torch and vvc_torch are imported inside the tests, so that a test worker
# that never runs them does not load torch beside JAX.


@pytest.mark.usefixtures("release_jax_programs")
@pytest.mark.parametrize("w,h,kw", [(128, 64, {}),
                                    (256, 64, {"num_tile_cols": 2}),
                                    (128, 64, {"lmcs": True})],
                         ids=["single_tile", "two_tile_cols",
                              "frames_search_path"])
def test_lossless_ai_stream_byte_equal_and_decodes(w, h, kw):
    from vvc_torch.enc.encoder import encode_sequence as port_encode
    from vvc_torch.io.synth import synth_frame as port_synth_frame
    frames = [synth_frame(w, h, t) for t in range(2)]
    want, _, _ = ref_encode(frames, qp=32, lossless=True, **kw)
    got, recons, stats = port_encode(
        [port_synth_frame(w, h, t) for t in range(2)], qp=32, lossless=True,
        device="cpu", **kw)
    assert got == want
    for f, r in zip(frames, recons):
        for a, b in ((f.y, r.y), (f.cb, r.cb), (f.cr, r.cr)):
            np.testing.assert_array_equal(a, b)
    assert [s["poc"] for s in stats] == [0, 1]
    dec, info = decode_stream(got)
    assert len(info["hash_ok"]) == 2 and all(info["hash_ok"])
    for f, d in zip(frames, dec):
        for a, b in ((f.y, d.y), (f.cb, d.cb), (f.cr, d.cr)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kw,match", [({"lossless": False, "lmcs": True},
                                       "slice 2d"),
                                      ({"lossless": False, "mode": "ra",
                                        "lmcs": True}, "slice 2d"),
                                      ({"lossless": True, "target_kbps": 500},
                                       "rate-control item"),
                                      ({"lossless": True, "wpp": True},
                                       "slice 2d")])
def test_options_of_later_slices_raise(kw, match):
    from vvc_torch.enc.encoder import encode_sequence as port_encode
    from vvc_torch.io.synth import synth_frame as port_synth_frame
    frames = [port_synth_frame(64, 64, 0)]
    with pytest.raises(NotImplementedError, match=match) as err:
        port_encode(frames, qp=32, device="cpu", **kw)
    assert "slice 2b" not in str(err.value)
    assert "slice 3" not in str(err.value)


# the lossy configuration of slice 2a: LFNST, CCLM, SAO and ALF stay at
# their SPS defaults (off)
LOSSY = dict(deblocking=True, mts_intra=True, mip=True)


def _encode_frames_equal_and_decode(sps_kw, w, h, qp, cols, frames,
                                    port_frames):
    """Encode `frames` with vvc's Encoder and the port's; assert equal
    NALs and recons, decode vvc's stream with MD5 checks; return the
    port's stats and leaves per picture."""
    from vvc_torch.enc.encoder import Encoder
    from vvc_torch.hls.ps import PPS as PortPPS, SPS as PortSPS
    ref = RefEncoder(SPS(width=w, height=h, **sps_kw),
                     PPS(init_qp=qp, num_tile_cols=cols))
    port = Encoder(PortSPS(width=w, height=h, **sps_kw),
                   PortPPS(init_qp=qp, num_tile_cols=cols), device="cpu")
    nals = [NalUnit(NalUnitType.SPS, write_sps(ref.sps)),
            NalUnit(NalUnitType.PPS, write_pps(ref.pps))]
    recons, out = [], []
    for poc, (f, pf) in enumerate(zip(frames, port_frames)):
        want, want_rec, _ = ref.encode_frame(f, poc)
        got, got_rec, stats = port.encode_frame(pf, poc)
        assert [(n.nal_type, n.payload) for n in got] == [
            (n.nal_type, n.payload) for n in want]
        for a, b in ((want_rec.y, got_rec.y), (want_rec.cb, got_rec.cb),
                     (want_rec.cr, got_rec.cr)):
            np.testing.assert_array_equal(a, b)
        assert stats["n_tiles"] == cols and 25 < stats["psnr_y"] < 60
        nals += want
        recons.append(got_rec)
        out.append((stats, port.last_leaves))
    dec, info = decode_stream(write_annexb(nals))
    assert len(info["hash_ok"]) == len(frames) and all(info["hash_ok"])
    for r, d in zip(recons, dec):
        for a, b in ((r.y, d.y), (r.cb, d.cb), (r.cr, d.cr)):
            np.testing.assert_array_equal(a, b)
    return out


@pytest.mark.usefixtures("release_jax_programs")
@pytest.mark.parametrize("cols,qp", [(1, 32), (2, 37)],
                         ids=["single_tile", "two_tile_cols"])
def test_lossy_ai_encode_frame_byte_equal_and_decodes(cols, qp):
    from vvc_torch.io.synth import synth_frame as port_synth_frame
    w, h = 128, 64
    _encode_frames_equal_and_decode(
        LOSSY, w, h, qp, cols, [synth_frame(w, h, poc) for poc in range(2)],
        [port_synth_frame(w, h, poc) for poc in range(2)])


# slice 2b: LFNST and CCLM on, as vvc's lossy encode_sequence SPS has them
LOSSY_2B = dict(LOSSY, lfnst=True, cclm=True)


@pytest.mark.usefixtures("release_jax_programs")
@pytest.mark.parametrize("cols,qp", [(1, 32), (2, 32)],
                         ids=["single_tile", "two_tile_cols"])
def test_2b_encode_frame_byte_equal_and_decodes(cols, qp):
    """Two 128×64 pictures with LFNST and the device chroma decision:
    CCLM leaves (chroma modes 1..3) are coded and reconstructed as vvc
    does."""
    from vvc_torch.io.synth import synth_frame as port_synth_frame
    w, h = 128, 64
    out = _encode_frames_equal_and_decode(
        LOSSY_2B, w, h, qp, cols, [synth_frame(w, h, poc) for poc in range(2)],
        [port_synth_frame(w, h, poc) for poc in range(2)])
    assert any(l.chroma_mode > 0 for _, leaves in out for l in leaves)


@pytest.mark.usefixtures("release_jax_programs")
def test_2b_encode_frame_smooth_lfnst_leaves():
    """One 128×128 smooth picture at QP 37, where the search picks LFNST:
    its leaves take the native recon's and the tree writer's LFNST paths
    (lfnst_idx syntax, the inverse secondary transform)."""
    from vvc.io.yuv import Frame
    from vvc_torch.io.yuv import Frame as PortFrame
    from tests.test_torch_rdo import smooth_frame
    y, cb, cr = smooth_frame()
    out = _encode_frames_equal_and_decode(
        LOSSY_2B, 128, 128, 37, 1, [Frame(y, cb, cr, 8)],
        [PortFrame(y.copy(), cb.copy(), cr.copy(), 8)])
    assert any(l.lfnst > 0 for _, leaves in out for l in leaves)


@pytest.mark.parametrize("option,match", [("lmcs", "slice 2d"),
                                          ("wpp", "slice 2d")])
def test_lossy_options_of_later_slices_raise(option, match):
    """LMCS (an SPS option) and WPP (a PPS option) raise at encode_frame."""
    from vvc_torch.enc.encoder import Encoder
    from vvc_torch.hls.ps import PPS as PortPPS, SPS as PortSPS
    from vvc_torch.io.synth import synth_frame as port_synth_frame
    sps_kw = {option: True} if option != "wpp" else {}
    enc = Encoder(PortSPS(width=64, height=64, **LOSSY, **sps_kw),
                  PortPPS(init_qp=32, wpp=option == "wpp"), device="cpu")
    with pytest.raises(NotImplementedError, match=match) as err:
        enc.encode_frame(port_synth_frame(64, 64, 0), 0)
    assert "slice 3" not in str(err.value)


def _cosited(f, frame_cls):
    """A frame whose chroma carries the luma's co-sited detail (Cb =
    Y[::2, ::2], Cr its complement): content on which CC-ALF turns on."""
    mx = (1 << f.bit_depth) - 1
    cb = f.y[::2, ::2].astype(np.int32)
    return frame_cls(f.y, cb, (mx - cb).astype(np.int32), f.bit_depth)


def _frames(w, h, bit_depth, n, cosited_last, frame_cls, synth):
    """n synthetic frames (scaled to bit_depth); with cosited_last the
    last one carries co-sited chroma."""
    out = []
    for t in range(n):
        f = synth(w, h, t)
        s = bit_depth - 8
        f = frame_cls(f.y << s, f.cb << s, f.cr << s, bit_depth)
        out.append(_cosited(f, frame_cls) if cosited_last and t == n - 1
                   else f)
    return out


@pytest.mark.usefixtures("release_jax_programs")
@pytest.mark.parametrize("cols,bit_depth,n", [(1, 8, 2), (2, 8, 2),
                                              (1, 10, 1)],
                         ids=["single_tile", "two_tile_cols", "ten_bit"])
def test_lossy_encode_sequence_byte_equal_and_decodes(cols, bit_depth, n):
    """Lossy encode_sequence with vvc's defaults (MTS, MIP, LFNST, CCLM,
    deblocking, SAO, ALF, CC-ALF) at QP 32 on 128×64: the AI pipeline
    (one tile, chroma planes given to the dispatched search) and the tile
    path (rdo_partition_tiled).  Streams and recons equal vvc's, the
    stream decodes with MD5 OK, and the filters act: SAO with EO and BO,
    a luma ALF filter with CTU flags on, the chroma ALF filter, CC-ALF on
    a plane (the single-tile case, whose second frame has co-sited
    chroma)."""
    from vvc.io.yuv import Frame
    from vvc_torch.enc.encoder import encode_sequence as port_encode
    from vvc_torch.io.synth import synth_frame as port_synth_frame
    from vvc_torch.io.yuv import Frame as PortFrame
    w, h = 128, 64
    frames = _frames(w, h, bit_depth, n, cols == 1 and n > 1, Frame,
                     synth_frame)
    port_frames = _frames(w, h, bit_depth, n, cols == 1 and n > 1,
                          PortFrame, port_synth_frame)
    want, want_rec, _ = ref_encode(frames, qp=32, bit_depth=bit_depth,
                                   num_tile_cols=cols)
    got, recons, stats = port_encode(port_frames, qp=32,
                                     bit_depth=bit_depth,
                                     num_tile_cols=cols, device="cpu")
    assert got == want
    for a, b in zip(want_rec, recons):
        for p, q in ((a.y, b.y), (a.cb, b.cb), (a.cr, b.cr)):
            np.testing.assert_array_equal(p, q)
    dec, info = decode_stream(got)
    assert len(info["hash_ok"]) == n and all(info["hash_ok"])
    for r, d in zip(recons, dec):
        for p, q in ((r.y, d.y), (r.cb, d.cb), (r.cr, d.cr)):
            np.testing.assert_array_equal(p, q)
    assert all(s["n_tiles"] == cols and 25 < s["psnr_y"] < 60 for s in stats)
    sao = np.sum([s["sao_types"] for s in stats], axis=0)   # [comp, type]
    alf = [s["alf"] for s in stats]
    assert sao[:, 2].sum() > 0                               # EO
    if cols == 1 and n > 1:
        assert any(a["luma_filters"] and a["ctu_on"] for a in alf)
        assert sao[:, 1].sum() > 0                           # BO
        assert any(a["chroma"] for a in alf)
        assert any(a["ccalf_cb"] or a["ccalf_cr"] for a in alf)

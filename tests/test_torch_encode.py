"""The port's encoder (vvc_torch.enc.encoder) against vvc's: lossless
All-Intra streams (encode_sequence) and lossy All-Intra pictures with MTS,
MIP and deblocking (Encoder.encode_frame) are byte-equal, single-tile and
with 2 tile columns, the reconstructions are equal, and vvc's decoder
decodes them with every picture hash OK.  Options of later slices raise.
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

# torch and vvc_torch are imported inside the tests, so that a test worker
# that never runs them does not load torch beside JAX.


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


@pytest.mark.parametrize("kw,match", [({"lossless": False}, "slice 2b"),
                                      ({"lossless": True, "mode": "ra"},
                                       "inter slice"),
                                      ({"lossless": True, "target_kbps": 500},
                                       "slice 2b"),
                                      ({"lossless": True, "wpp": True},
                                       "slice 2c")])
def test_options_of_later_slices_raise(kw, match):
    from vvc_torch.enc.encoder import encode_sequence as port_encode
    from vvc_torch.io.synth import synth_frame as port_synth_frame
    frames = [port_synth_frame(64, 64, 0)]
    with pytest.raises(NotImplementedError, match=match):
        port_encode(frames, qp=32, device="cpu", **kw)


# the lossy configuration of slice 2a: LFNST, CCLM, SAO and ALF stay at
# their SPS defaults (off)
LOSSY = dict(deblocking=True, mts_intra=True, mip=True)


@pytest.mark.parametrize("cols,qp", [(1, 32), (2, 37)],
                         ids=["single_tile", "two_tile_cols"])
def test_lossy_ai_encode_frame_byte_equal_and_decodes(cols, qp):
    from vvc_torch.enc.encoder import Encoder
    from vvc_torch.hls.ps import PPS as PortPPS, SPS as PortSPS
    from vvc_torch.io.synth import synth_frame as port_synth_frame
    w, h = 128, 64
    ref = RefEncoder(SPS(width=w, height=h, **LOSSY),
                     PPS(init_qp=qp, num_tile_cols=cols))
    port = Encoder(PortSPS(width=w, height=h, **LOSSY),
                   PortPPS(init_qp=qp, num_tile_cols=cols), device="cpu")
    nals = [NalUnit(NalUnitType.SPS, write_sps(ref.sps)),
            NalUnit(NalUnitType.PPS, write_pps(ref.pps))]
    recons = []
    for poc in range(2):
        want, want_rec, _ = ref.encode_frame(synth_frame(w, h, poc), poc)
        got, got_rec, stats = port.encode_frame(port_synth_frame(w, h, poc),
                                                poc)
        assert [(n.nal_type, n.payload) for n in got] == [
            (n.nal_type, n.payload) for n in want]
        for a, b in ((want_rec.y, got_rec.y), (want_rec.cb, got_rec.cb),
                     (want_rec.cr, got_rec.cr)):
            np.testing.assert_array_equal(a, b)
        assert stats["n_tiles"] == cols and 25 < stats["psnr_y"] < 60
        nals += want
        recons.append(got_rec)
    dec, info = decode_stream(write_annexb(nals))
    assert len(info["hash_ok"]) == 2 and all(info["hash_ok"])
    for r, d in zip(recons, dec):
        np.testing.assert_array_equal(r.y, d.y)


@pytest.mark.parametrize("option,match", [("lfnst", "slice 2b"),
                                          ("cclm", "slice 2b"),
                                          ("sao", "slice 3"),
                                          ("alf", "slice 3")])
def test_lossy_options_of_later_slices_raise(option, match):
    from vvc_torch.enc.encoder import Encoder
    from vvc_torch.hls.ps import PPS as PortPPS, SPS as PortSPS
    from vvc_torch.io.synth import synth_frame as port_synth_frame
    enc = Encoder(PortSPS(width=64, height=64, **LOSSY, **{option: True}),
                  PortPPS(init_qp=32), device="cpu")
    with pytest.raises(NotImplementedError, match=match):
        enc.encode_frame(port_synth_frame(64, 64, 0), 0)

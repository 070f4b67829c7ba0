"""The port's encoder (vvc_torch.enc.encoder) against vvc's: lossless
All-Intra streams are byte-equal, single-tile and with 2 tile columns,
and vvc's decoder reproduces the source with every picture hash OK.
Tolerance: exact (bytes and samples)."""
import numpy as np
import pytest

from vvc.dec.decoder import decode_stream
from vvc.enc.encoder import encode_sequence as ref_encode
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


@pytest.mark.parametrize("kw,match", [({"lossless": False}, "slice 2"),
                                      ({"lossless": True, "mode": "ra"},
                                       "inter slice"),
                                      ({"lossless": True, "target_kbps": 500},
                                       "slice 2"),
                                      ({"lossless": True, "wpp": True},
                                       "slice 2")])
def test_options_of_later_slices_raise(kw, match):
    from vvc_torch.enc.encoder import encode_sequence as port_encode
    from vvc_torch.io.synth import synth_frame as port_synth_frame
    frames = [port_synth_frame(64, 64, 0)]
    with pytest.raises(NotImplementedError, match=match):
        port_encode(frames, qp=32, device="cpu", **kw)

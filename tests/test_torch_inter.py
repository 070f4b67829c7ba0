"""The port's inter search and inter GOPs (vvc_torch.enc.inter_search,
vvc_torch.enc.encoder) against vvc's on the CPU, on a clip in global
sub-pel motion (vvc_torch.io.synth.motion_clip: 4.25 px right and 1.25 px
up per frame, so integer and fractional MVs win):

  * `me_v2_program`'s packed vectors (rd cost, direction, MVs, refs) equal
    `_me_v2_program`'s at 128×64, size 16 with the 8×8 children, for P
    with 1 reference, B with 1+1 and B with 2+2, and with affine (the
    affine flag and corner points too) for P with 1 reference and B with
    1+1 on a zoom clip (one vvc compile each);
  * whole streams byte-equal to vvc's and decoded by vvc's decoder with
    every picture hash OK: LDP (3 frames, single tile and 2 tile columns),
    and, marked `slow` (their vvc compiles take minutes), LDB (3 frames)
    and RA with GOP 4 (5 frames: I, P and B with up to 2 refs per list);
  * a resumed RA encode (checkpoint at GOP boundaries) equals the
    uninterrupted one (port against port);
  * with each of several slice-4b options the SPS equals vvc's;
  * the host chroma decision of intra leaves (`_decide_chroma_modes`),
    which vvc's inter pictures never reach, equals vvc's.

Tolerance: exact (float32 costs bit for bit, bytes, samples)."""
import numpy as np
import pytest

import jax.numpy as jnp

from vvc.dec.decoder import decode_stream
from vvc.enc import me as ref_me
from vvc.enc.encoder import encode_sequence as ref_encode
from vvc.enc.inter_search import _me_v2_program
from vvc.io.yuv import Frame

from tests.test_torch_rdo import (  # noqa: F401
    _one_torch_thread, release_jax_programs)

# torch and vvc_torch are imported inside the tests, so that a test worker
# that never runs them does not load torch beside JAX.

W, H = 128, 64


def _clips(n: int):
    """The motion clip for vvc (vvc Frames) and for the port (its own)."""
    from vvc_torch.io.synth import motion_clip
    port = motion_clip(n, W, H)
    return [Frame(f.y.copy(), f.cb.copy(), f.cr.copy(), 8) for f in port], \
        port


@pytest.mark.usefixtures("release_jax_programs")
@pytest.mark.parametrize("n_l0,n_l1,is_b,affine",
                         [(1, 0, False, False), (1, 1, True, False),
                          (2, 2, True, False), (1, 0, False, True),
                          (1, 1, True, True)],
                         ids=["P_1ref", "B_1+1", "B_2+2", "P_1ref_affine",
                              "B_1+1_affine"])
def test_me_v2_program_packed_equal(n_l0, n_l1, is_b, affine):
    """Size 16 with the 8×8 children; with affine, the parent grid also
    carries the affine search of reference 0 of each list (on the zoom
    clip of tests/test_affine.py, where it changes decisions)."""
    import torch
    from vvc_torch.enc import me
    from vvc_torch.enc.inter_search import me_v2_program
    _, port = _clips(5)
    if affine:
        port = _zoom_clip(5)
    y = port[2].y
    refs = [port[i].y for i in (1, 0, 3, 4)][:n_l0 + n_l1]
    pads, dss = zip(*(ref_me._prep_ref(jnp.asarray(r), H, W) for r in refs))
    yds = ref_me._prep_ref(jnp.asarray(y), H, W)[1]
    coarse = ref_me._coarse_program(yds, jnp.stack(dss), H // 4, W // 4,
                                    ref_me.COARSE_R)
    want, want_c = _me_v2_program(jnp.asarray(y), jnp.stack(pads),
                                  coarse[16], jnp.int32(32), 16, 8, W, H,
                                  n_l0, n_l1, is_b, affine, True)
    t_pads, t_dss = zip(*(me.prep_ref(torch.from_numpy(r)) for r in refs))
    t_coarse = me.coarse_search(me.prep_ref(torch.from_numpy(y))[1],
                                torch.stack(t_dss))
    np.testing.assert_array_equal(t_coarse[16].numpy(),
                                  np.asarray(coarse[16]))
    got, got_c = me_v2_program(torch.from_numpy(y), torch.stack(t_pads),
                               t_coarse[16], 32, 16, 8, W, H, n_l0, n_l1,
                               is_b, affine, True)
    for g, wv in ((got, want), (got_c, want_c)):
        np.testing.assert_array_equal(g.numpy().view(np.int32),
                                      np.asarray(wv).view(np.int32))
    if affine:
        n16 = (H // 16) * (W // 16)
        aff = got.numpy()[8 * n16:9 * n16]
        assert (aff == 4).any()                 # affine wins some blocks
        return
    n8 = (H // 8) * (W // 8)
    mvx0 = got_c.numpy()[2 * n8:3 * n8]
    dirs = got_c.numpy()[n8:2 * n8]
    assert (mvx0 != 0).any() and (mvx0 % 4 != 0).any()   # sub-pel motion
    if is_b:
        assert set(np.unique(dirs)) > {1.0}


def _zoom_clip(n: int):
    """The port's frames of the zoom clip of tests/test_affine.py at
    W×H."""
    from tests.test_affine import _warp_frames
    from vvc_torch.io.yuv import Frame as PortFrame
    return [PortFrame(f.y.copy(), f.cb.copy(), f.cr.copy(), 8)
            for f in _warp_frames(n, H=H, W=W, zoom=0.035)]


def _equal_and_decodes(want, got, recons, n):
    assert got == want
    dec, info = decode_stream(got)
    assert len(info["hash_ok"]) == n and all(info["hash_ok"])
    for r, d in zip(recons, dec):
        for a, b in ((r.y, d.y), (r.cb, d.cb), (r.cr, d.cr)):
            np.testing.assert_array_equal(a, b)


def _inter_stats(stats):
    dirs = np.sum([s["leaf_dirs"] for s in stats if s["slice_type"] != 2],
                  axis=0)
    return dirs


@pytest.mark.usefixtures("release_jax_programs")
def test_ldp_stream_byte_equal_and_decodes():
    """LDP, 3 frames at QP 32: single tile, then 2 tile columns (the
    inter search is frame-wide, so both share vvc's compiles)."""
    from vvc_torch.enc.encoder import encode_sequence as port_encode
    frames, port = _clips(3)
    for cols in (1, 2):
        want, _, _ = ref_encode(frames, qp=32, mode="ldp",
                                num_tile_cols=cols)
        got, recons, stats = port_encode(port, qp=32, mode="ldp",
                                         num_tile_cols=cols, device="cpu")
        _equal_and_decodes(want, got, recons, 3)
        assert [s["slice_type"] for s in stats] == [2, 1, 1]
        dirs = _inter_stats(stats)
        assert dirs[1] > 0 and dirs[0] == 0      # vvc's inter pictures


@pytest.mark.slow
@pytest.mark.usefixtures("release_jax_programs")
def test_ldb_stream_byte_equal_and_decodes():
    from vvc_torch.enc.encoder import encode_sequence as port_encode
    frames, port = _clips(3)
    want, _, _ = ref_encode(frames, qp=32, mode="ldb")
    got, recons, stats = port_encode(port, qp=32, mode="ldb", device="cpu")
    _equal_and_decodes(want, got, recons, 3)
    assert [s["slice_type"] for s in stats] == [2, 0, 0]


@pytest.mark.slow
@pytest.mark.usefixtures("release_jax_programs")
def test_ra_stream_byte_equal_and_decodes():
    from vvc_torch.enc.encoder import encode_sequence as port_encode
    frames, port = _clips(5)
    want, _, _ = ref_encode(frames, qp=32, mode="ra", gop_size=4)
    got, recons, stats = port_encode(port, qp=32, mode="ra", gop_size=4,
                                     device="cpu")
    _equal_and_decodes(want, got, recons, 5)
    assert [s["slice_type"] for s in stats] == [2, 0, 0, 0, 1]
    assert _inter_stats(stats)[3] > 0                      # bi leaves


def test_ra_resume_equals_uninterrupted(tmp_path):
    """Checkpoint at every GOP boundary, then resume from the last one:
    the stream and the recons equal an uninterrupted encode."""
    from vvc_torch.enc.encoder import encode_sequence as port_encode
    _, port = _clips(9)
    kw = dict(qp=32, mode="ra", gop_size=4, device="cpu")
    want, want_rec, _ = port_encode(port, **kw)
    ck = str(tmp_path / "enc.ckpt")
    port_encode(port, checkpoint_path=ck, **kw)
    got, recons, stats = port_encode(port, checkpoint_path=ck, resume=True,
                                     **kw)
    assert got == want
    assert all(s is not None for s in stats)
    for a, b in zip(want_rec, recons):
        np.testing.assert_array_equal(a.y, b.y)


@pytest.mark.parametrize("kw,what", [({"affine": True}, "affine"),
                                     ({"mctf": True}, "mctf"),
                                     ({"bdof": True}, "bdof"),
                                     ({"gpm": True}, "gpm"),
                                     ({"mmvd": True}, "mmvd")])
def test_slice_4b_options_raise(kw, what):
    """Until slice 4b these options raised; now they run.  The SPS the
    port's encode_sequence writes with the option (RA, GOP 4) is byte-equal
    to the one vvc's encode_sequence builds from the same arguments, and it
    carries the option's flag (MCTF has none: its SPS is the default's)."""
    from vvc.hls.ps import SPS as RefSPS
    from vvc.hls.write import write_sps as ref_write_sps
    from vvc_torch.common.types import NalUnitType
    from vvc_torch.enc.encoder import encode_sequence as port_encode
    from vvc_torch.io.nal import read_annexb
    _, port = _clips(2)
    bs, _, _ = port_encode(port, qp=32, mode="ra", gop_size=4, device="cpu",
                           **kw)
    sps = [n.payload for n in read_annexb(bs)
           if n.nal_type == NalUnitType.SPS]
    flags = {k: v for k, v in kw.items() if k != "mctf"}
    want = ref_write_sps(RefSPS(
        width=W, height=H, bit_depth=8, ctu_size=64, deblocking=True,
        mts_intra=True, mip=True, lfnst=True, sao=True, alf=True, cclm=True,
        **flags))
    assert sps == [want]
    assert (want != ref_write_sps(RefSPS(
        width=W, height=H, bit_depth=8, ctu_size=64, deblocking=True,
        mts_intra=True, mip=True, lfnst=True, sao=True, alf=True,
        cclm=True))) == (what != "mctf")


def test_decide_chroma_modes_equal():
    """The host chroma decision of intra leaves in inter pictures
    (`_decide_chroma_modes`, with the numpy `luma_ds_plane` and
    `derive_models_batch` of vvc/kernels/cclm.py) equals vvc's.  vvc's
    inter DP never picks intra, so the streams do not reach it."""
    from vvc.enc.encoder import _decide_chroma_modes as ref_decide
    from vvc.model.frame import Leaf as RefLeaf
    from vvc_torch.enc.encoder import _decide_chroma_modes
    from vvc_torch.model.frame import Leaf
    frames, port = _clips(1)
    rng = np.random.default_rng(3)
    spec = [(x, y, s, int(rng.integers(0, 67)))
            for s in (8, 16, 32) for y in range(0, H, s)
            for x in range(0, W, s)]
    want = [RefLeaf(x, y, s, s, m) for x, y, s, m in spec]
    got = [Leaf(x, y, s, s, m) for x, y, s, m in spec]
    ref_decide(want, frames[0], 8)
    _decide_chroma_modes(got, port[0], 8)
    modes = [g.chroma_mode for g in got]
    assert modes == [w.chroma_mode for w in want]
    assert len(set(modes)) > 1

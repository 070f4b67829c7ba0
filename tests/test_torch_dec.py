"""The port's decoder (vvc_torch.dec) against vvc's (vvc.dec).

On small streams that vvc's encoder writes — All-Intra lossy with the
default tools (MIP, LFNST, CCLM, SAO, ALF, CC-ALF), lossless, 2 tile
columns, WPP, LMCS (AI and an LDP GOP), LDP, RA GOP 4 with the ten
slice-4b options, and MTT + ISP + MRL + dependent quantization — the
port's `decode_stream(device="cpu")` gives vvc's frames, hash status and
POC order on the host path, and with `wavefront=True` vvc's wavefront
frames on the lossy, lossless, 2-tile and MIP/LFNST/CCLM-laden streams.
`_recon_wave_group` gives vvc's plane and order map on the same leaves;
the twins of the four decoder kernels (`wave_ref_lines`, `dequant`,
`wave_cclm`, `wave_commit`) equal their references, and `intra_pred_one`
equals vvc's pick from all 67 modes at every size.  A corrupted byte gives
HashMismatch, as in vvc.  Tolerance: exact everywhere (integer samples).
"""
import numpy as np
import pytest

from vvc.dec import decoder as ref_dec
from vvc.dec import wavefront as ref_wf
from vvc.enc.encoder import encode_sequence as ref_encode
from vvc.io.synth import synth_frame
from vvc.io.yuv import Frame

from tests.test_torch_rdo import (  # noqa: F401
    _one_torch_thread, release_jax_programs)

# torch and vvc_torch are imported inside the tests and fixtures, so that a
# test worker that never runs them does not load torch beside JAX.

W, H = 128, 64
TOOLS_4B = dict(affine=True, mctf=True, bdof=True, dmvr=True, mmvd=True,
                ciip=True, gpm=True, amvr=True, smvd=True, bcw=True)


def _clip(n, w=W, h=H):
    from vvc_torch.io.synth import motion_clip
    return [Frame(f.y.copy(), f.cb.copy(), f.cr.copy(), 8)
            for f in motion_clip(n, w, h)]


def _tool_clip(n, w=W, h=H):
    from chip_smoke import tool_clip
    c = np.full((h // 2, w // 2), 128, np.int32)
    return [Frame(y, c.copy(), c.copy(), 8) for y in tool_clip(n, w, h)]


def _port_encode(frames, **kw):
    from vvc_torch.enc.encoder import encode_sequence
    from vvc_torch.io.yuv import Frame as PortFrame
    return encode_sequence([PortFrame(f.y.copy(), f.cb.copy(), f.cr.copy(), 8)
                            for f in frames], device="cpu", **kw)


def _laden_frames(w=W, h=H):
    """synth_frame 0 (at QP 27 MIP, LFNST and all three LM variants win
    on it) and a picture whose chroma tracks luma along one axis (more
    one-sided LM variants)."""
    ys, xs = np.mgrid[0:h, 0:w]
    y1 = ((xs * 2 + ys + 7) % 256).astype(np.int32)
    cys, cxs = np.mgrid[0:h // 2, 0:w // 2]
    cb = ((cxs * 4 + 3) % 200 + 20).astype(np.int32)
    cr = ((cys * 4 + 5) % 200 + 20).astype(np.int32)
    return [synth_frame(w, h, 0), Frame(y1, cb, cr, 8)]


STREAMS = {
    "ai": lambda: ref_encode([synth_frame(W, H, t) for t in range(2)],
                             qp=32),
    "lossless": lambda: ref_encode([synth_frame(W, H, t) for t in range(2)],
                                   qp=32, lossless=True),
    "two_tile_cols": lambda: ref_encode(
        [synth_frame(W, H, t) for t in range(2)], qp=32, num_tile_cols=2),
    "wpp": lambda: ref_encode([synth_frame(W, H, t) for t in range(2)],
                              qp=32, wpp=True),
    "lmcs_ai": lambda: ref_encode([synth_frame(W, H, t) for t in range(2)],
                                  qp=32, lmcs=True),
    "lmcs_ldp": lambda: ref_encode(_clip(3), qp=32, mode="ldp", lmcs=True),
    "ldp": lambda: ref_encode(_clip(3), qp=32, mode="ldp"),
    "ra_4b": lambda: ref_encode(_tool_clip(5), qp=32, mode="ra", gop_size=4,
                                **TOOLS_4B),
    "mtt_isp_mrl_dq": lambda: ref_encode(
        [synth_frame(W, H, t) for t in range(2)], qp=32, mtt=True, isp=True,
        mrl=True, dep_quant=True),
    "laden": lambda: ref_encode(_laden_frames(), qp=27),
    # the same inter and MTT configurations written by the port's encoder
    # (byte-equal to vvc's: tests/test_torch_inter.py, test_torch_mtt.py,
    # test_torch_affine.py), which needs none of vvc's minutes of compiles
    "ldp_port_enc": lambda: _port_encode(_clip(3), qp=32, mode="ldp"),
    "ra_4b_port_enc": lambda: _port_encode(_tool_clip(5), qp=32, mode="ra",
                                           gop_size=4, **TOOLS_4B),
    "mtt_isp_mrl_dq_port_enc": lambda: _port_encode(
        [synth_frame(W, H, t) for t in range(2)], qp=32, mtt=True, isp=True,
        mrl=True, dep_quant=True),
}
# vvc's search programs for these compile for minutes
SLOW = ("lmcs_ldp", "ldp", "ra_4b", "mtt_isp_mrl_dq")
WAVEFRONT = ("ai", "lossless", "two_tile_cols", "laden")


@pytest.fixture(scope="module")
def streams():
    """name → (bytes, recons): each stream encoded by vvc once per module
    and worker, on first use."""
    cache = {}

    def get(name):
        if name not in cache:
            bs, recons, _ = STREAMS[name]()
            cache[name] = (bs, recons)
        return cache[name]
    return get


def _frames_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for pa, pb in zip(a.planes(), b.planes()):
            np.testing.assert_array_equal(pa, pb)


@pytest.mark.usefixtures("release_jax_programs")
@pytest.mark.parametrize("name", [pytest.param(n, marks=pytest.mark.slow)
                                  if n in SLOW else n for n in STREAMS])
def test_host_decode_equals_vvc(streams, name):
    from vvc_torch.dec.decoder import decode_stream
    bs, recons = streams(name)
    want, winfo = ref_dec.decode_stream(bs)
    got, info = decode_stream(bs, device="cpu")
    _frames_equal(got, want)
    _frames_equal(got, recons)
    assert info["hash_ok"] == winfo["hash_ok"] and all(info["hash_ok"])
    assert info["decode_order_pocs"] == winfo["decode_order_pocs"]
    assert info["sps"].width == W


@pytest.mark.usefixtures("release_jax_programs")
@pytest.mark.parametrize("name", WAVEFRONT)
def test_wavefront_decode_equals_vvc(streams, name, monkeypatch):
    from vvc_torch.dec import wavefront
    from vvc_torch.dec.decoder import decode_stream
    bs, recons = streams(name)
    seen = []
    inner = wavefront.reconstruct_leaves_wavefront

    def spy(leaves, *a, **kw):
        seen.extend(leaves)
        return inner(leaves, *a, **kw)
    monkeypatch.setattr(wavefront, "reconstruct_leaves_wavefront", spy)
    got, info = decode_stream(bs, wavefront=True, device="cpu")
    want, winfo = ref_dec.decode_stream(bs, wavefront=True)
    _frames_equal(got, want)
    _frames_equal(got, recons)
    assert info["hash_ok"] == winfo["hash_ok"] and all(info["hash_ok"])
    assert info["decode_order_pocs"] == winfo["decode_order_pocs"]
    assert seen, "the wavefront path did not run"
    if name == "laden":
        assert any(lf.luma_mode >= 67 for lf in seen), "no MIP leaf"
        assert any(lf.lfnst for lf in seen), "no LFNST leaf"
        assert {lf.chroma_mode for lf in seen} >= {1, 2, 3}, \
            "not every CCLM variant"
    if name == "lossless":
        assert any(lf.bdpcm for lf in seen), "no BDPCM leaf"


def _outcome(decode, data):
    try:
        _, info = decode(data)
        return "ok", tuple(info["hash_ok"])
    except Exception as e:                          # noqa: BLE001
        return (type(e).__name__,)


def _flip(bs, at, bit):
    return bs[:at] + bytes([bs[at] ^ bit]) + bs[at + 1:]


@pytest.mark.parametrize("name", ["ai", "lossless"])
def test_corrupt_byte_raises_hash_mismatch(streams, name):
    """A flipped bit in the first picture's MD5 SEI raises HashMismatch
    (with verify_hash=False, its hash status is False), and flipped bits
    in the first slice's payload end as vvc's decoder ends (a substream
    that does not terminate raises, a bit CABAC never reads decodes)."""
    from vvc_torch.dec.decoder import HashMismatch, decode_stream
    from vvc_torch.io.nal import read_annexb
    bs, _ = streams(name)
    nals = list(read_annexb(bs))
    sei = next(n for n in nals if n.nal_type == 24)
    bad = _flip(bs, bs.index(sei.payload) + 5, 0x01)
    with pytest.raises(ref_dec.HashMismatch):
        ref_dec.decode_stream(bad)
    with pytest.raises(HashMismatch):
        decode_stream(bad, device="cpu")
    for wf in (False, True):
        _, info = decode_stream(bad, verify_hash=False, wavefront=wf,
                                device="cpu")
        assert info["hash_ok"] == [False, True]
    sl = next(n for n in nals if n.nal_type in (0, 7, 8, 9))
    start = bs.index(sl.payload[:8])
    outcomes = set()
    for at in [start + len(sl.payload) * k // 8 for k in range(1, 8)] + [
            start + len(sl.payload) - 1]:
        bad = _flip(bs, at, 0x10)
        want = _outcome(ref_dec.decode_stream, bad)
        assert _outcome(lambda d: decode_stream(d, device="cpu"), bad) == want
        outcomes.add(want[0])
    assert outcomes == {"AssertionError", "ok"}


# ---------------------------------------------------------------------------
# _recon_wave_group on the same leaves
# ---------------------------------------------------------------------------


class _Leaf:
    """The fields of a Leaf that _recon_wave_group reads."""

    def __init__(self, luma_mode, chroma_mode=0, lfnst=0, bdpcm=0):
        self.luma_mode, self.chroma_mode = luma_mode, chroma_mode
        self.lfnst, self.bdpcm = lfnst, bdpcm


def _wave_group(rng, plane_hw, s, n, comp, lossless, cclm):
    """n non-overlapping s×s leaves of one wave on a plane whose upper
    part is reconstructed, with an order map of z-order indices, and
    random modes, MTS, LFNST, BDPCM and levels."""
    ph, pw = plane_hw
    bd = 8
    plane = rng.integers(0, 1 << bd, size=(ph, pw)).astype(np.int32)
    big = np.iinfo(np.int32).max
    order = rng.integers(0, 400, size=((ph + 3) >> 2, (pw + 3) >> 2)
                         ).astype(np.int32)
    cells = [(x, y) for y in range(0, ph - s + 1, 2 * s)
             for x in range(0, pw - s + 1, s)]
    pick = rng.choice(len(cells), size=min(n, len(cells)), replace=False)
    group = []
    for j, c in enumerate(sorted(pick)):
        x0, y0 = cells[c]
        order[y0 >> 2:(y0 + s + 3) >> 2, x0 >> 2:(x0 + s + 3) >> 2] = big
        zi = int(rng.integers(100, 300))
        mode = int(rng.integers(0, 67))
        if comp == 0 and 8 <= s <= 32 and j % 3 == 1:
            mode = 67 + int(rng.integers(0, 9))                # MIP
        mts = int(rng.integers(0, 5)) if s <= 32 and not lossless else 0
        lfnst = (int(rng.integers(1, 3)) if comp == 0 and s >= 8
                 and mts == 0 and j % 2 == 0 else 0)
        lv = None
        if j % 4 != 3:
            lv = (rng.integers(-40, 41, size=(s, s))
                  * (rng.random((s, s)) < 0.3)).astype(np.int32)
            if lfnst:
                lv[4:, :] = 0
                lv[:, 4:] = 0
        leaf = _Leaf(mode, chroma_mode=int(rng.integers(0, 4)) if cclm else 0,
                     lfnst=lfnst,
                     bdpcm=int(rng.integers(0, 3)) if lossless else 0)
        group.append((leaf, s, x0, y0, lv, mts, zi))
    return plane, order, group


@pytest.mark.usefixtures("release_jax_programs")
@pytest.mark.parametrize("comp,lossless,s", [
    (comp, lossless, s) for comp, lossless in ((0, False), (1, False),
                                               (0, True), (2, True))
    for s in (4, 8, 16, 32, 64) if comp == 0 or s <= 32])  # chroma <= 32
def test_recon_wave_group_equals_vvc(comp, lossless, s):
    import torch
    from vvc_torch.dec.wavefront import _recon_wave_group
    rng = np.random.default_rng(100 * s + 10 * comp + lossless)
    hw = (4 * s, 8 * s) if s <= 16 else (2 * s, 4 * s)
    cclm = comp != 0 and not lossless
    plane, order, group = _wave_group(rng, hw, s, 6, comp, lossless, cclm)
    ds = rng.integers(0, 256, size=hw).astype(np.int32) if cclm else None
    p_ref, o_ref = plane.copy(), order.copy()
    ref_wf._recon_wave_group(p_ref, o_ref, group, 32, 8, lossless, comp,
                             cclm_ds=ds)
    p, o = torch.from_numpy(plane.copy()), torch.from_numpy(order.copy())
    _recon_wave_group(p, o, group, 32, 8, lossless, comp,
                      cclm_ds=None if ds is None else torch.from_numpy(ds))
    np.testing.assert_array_equal(p.numpy(), p_ref)
    np.testing.assert_array_equal(o.numpy(), o_ref)


# ---------------------------------------------------------------------------
# The twins of the decoder kernels against their references
# ---------------------------------------------------------------------------


def _availability(rng, h, w, tile_x=None):
    """An order map with z-order indices: the rows above a random cut are
    reconstructed, the rest pending; with tile_x, the columns left of it
    belong to another tile (never available)."""
    big = np.iinfo(np.int32).max
    order = rng.integers(0, 200, size=((h + 3) >> 2, (w + 3) >> 2)
                         ).astype(np.int32)
    cut = int(rng.integers(1, order.shape[0]))
    order[cut:, :] = big
    order[rng.random(order.shape) < 0.1] = big
    if tile_x is not None:
        order[:, :tile_x >> 2] = big
    return order


@pytest.mark.parametrize("bit_depth", [8, 10])
@pytest.mark.parametrize("s", [4, 8, 16, 32, 64])
def test_wave_ref_lines_twin_equals_build_ref_line(s, bit_depth):
    import torch
    from vvc.kernels.intra import build_ref_line
    from vvc_torch.kernels.intra import build_ref_lines_wave_plain
    rng = np.random.default_rng(s * 3 + bit_depth)
    h, w = 3 * s + 12, 4 * s + 20            # ragged: leaves reach the edge
    plane = rng.integers(0, 1 << bit_depth, size=(h, w)).astype(np.int32)
    for tile_x in (None, 2 * s):
        order = _availability(rng, h, w, tile_x)
        xs = np.concatenate([[0, 0, w - s, tile_x or s, w - s],
                             rng.integers(0, w - s + 1, 40)]) & ~3
        ys = np.concatenate([[0, h - s, 0, s, h - s],
                             rng.integers(0, h - s + 1, 40)]) & ~3
        zis = rng.integers(0, 260, xs.shape[0])
        zis[:3] = [0, 10**6, 150]         # nothing / everything available
        want = np.stack([build_ref_line(plane, order < z, int(x), int(y), s,
                                        bit_depth)
                         for x, y, z in zip(xs, ys, zis)])
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32))
        got = build_ref_lines_wave_plain(t(plane), t(order), t(xs), t(ys),
                                         t(zis), s, bit_depth)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bit_depth", [8, 10])
def test_dequant_twin_equals_vvc_at_every_shape(bit_depth):
    import torch
    from vvc.kernels.quant import dequant_batch as ref_dequant
    from vvc_torch.kernels.quant import dequant_batch
    rng = np.random.default_rng(bit_depth)
    for h in (4, 8, 16, 32, 64):
        for w in (4, 8, 16, 32, 64):
            lv = rng.integers(-300, 301, size=(3, h, w)).astype(np.int32)
            lv[0, 0, :2] = [32767, -32768]      # reach the 16-bit clip
            lv[1, 0, :2] = [1 << 22, -(1 << 22)]  # reach the 2^29 guard
            for qp in (0, 4, 17, 32, 45, 51, 63):
                want = np.asarray(ref_dequant(lv, qp, bit_depth))
                got = dequant_batch(torch.from_numpy(lv), qp, bit_depth)
                np.testing.assert_array_equal(got.numpy(), want,
                                              err_msg=f"{w}x{h} qp {qp}")
                assert want.min() == -32768 and want.max() == 32767


@pytest.mark.parametrize("variant", [1, 2, 3])
@pytest.mark.parametrize("cs", [4, 8, 16, 32])
def test_wave_cclm_twin_equals_predict_cclm(cs, variant):
    import torch
    from vvc.kernels.cclm import predict_cclm
    from vvc_torch.kernels.cclm import predict_cclm_wave_plain
    rng = np.random.default_rng(cs * 7 + variant)
    for bit_depth in (8, 10):
        ch, cw = 3 * cs + 4, 4 * cs + 8
        ds = rng.integers(0, 1 << bit_depth, size=(ch, cw)).astype(np.int32)
        chroma = rng.integers(0, 1 << bit_depth, size=(ch, cw)
                              ).astype(np.int32)
        if cs == 8:                       # flat luma: den = 0
            ds[:] = 300
        order = _availability(rng, ch, cw, 2 * cs if variant == 1 else None)
        xs = np.concatenate([[0, cw - cs, 2 * cs, 0],
                             rng.integers(0, cw - cs + 1, 30)]) & ~3
        ys = np.concatenate([[0, 0, cs, ch - cs],
                             rng.integers(0, ch - cs + 1, 30)]) & ~3
        zis = rng.integers(0, 230, xs.shape[0])
        var = np.full(xs.shape[0], variant)
        var[::5] = 0                       # not CCLM: left as it is
        pred0 = rng.integers(0, 9, size=(xs.shape[0], cs, cs)
                             ).astype(np.int32)
        want = pred0.copy()
        for k in range(xs.shape[0]):
            if var[k]:
                want[k] = predict_cclm(ds, chroma, order < zis[k],
                                       int(xs[k]), int(ys[k]), cs, bit_depth,
                                       variant=variant)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32))
        got = predict_cclm_wave_plain(t(ds), t(chroma), t(order), t(xs),
                                      t(ys), t(zis), t(var), cs, bit_depth,
                                      t(pred0.copy()))
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("s", [4, 8, 16, 32, 64])
def test_wave_commit_twin_equals_reference(s):
    import torch
    from vvc.model.recon import _dpcm_inv
    from vvc_torch.dec.wavefront import commit_wave_plain
    rng = np.random.default_rng(s)
    h, w = 2 * s, 3 * s
    for bit_depth in (8, 10):
        plane = rng.integers(0, 1 << bit_depth, size=(h, w)).astype(np.int32)
        order = np.full(((h + 3) >> 2, (w + 3) >> 2), 7, np.int32)
        xs = np.array([0, s, 2 * s, 0, s, 2 * s], np.int32)
        ys = np.array([0, 0, 0, s, s, s], np.int32)
        zis = np.arange(6, dtype=np.int32) + 40
        bdpcm = np.array([0, 1, 2, 0, 1, 2], np.int32)
        pred = rng.integers(0, 1 << bit_depth, size=(6, s, s)
                            ).astype(np.int32)
        resi = rng.integers(-(1 << bit_depth), 1 << bit_depth,
                            size=(6, s, s)).astype(np.int32)
        want_p, want_o = plane.copy(), order.copy()
        for k in range(6):
            r = _dpcm_inv(resi[k], int(bdpcm[k])) if bdpcm[k] else resi[k]
            y0, x0 = int(ys[k]), int(xs[k])
            want_p[y0:y0 + s, x0:x0 + s] = np.clip(pred[k] + r, 0,
                                                   (1 << bit_depth) - 1)
            want_o[y0 >> 2:(y0 >> 2) + max(1, s >> 2),
                   x0 >> 2:(x0 >> 2) + max(1, s >> 2)] = zis[k]
        p, o = torch.from_numpy(plane.copy()), torch.from_numpy(order.copy())
        t = torch.from_numpy
        commit_wave_plain(p, o, t(pred), t(resi), t(xs), t(ys), t(zis),
                          t(bdpcm), bit_depth)
        np.testing.assert_array_equal(p.numpy(), want_p)
        np.testing.assert_array_equal(o.numpy(), want_o)


@pytest.mark.usefixtures("release_jax_programs")
@pytest.mark.parametrize("bit_depth", [8, 10])
@pytest.mark.parametrize("s", [4, 8, 16, 32, 64])
def test_intra_pred_one_equals_vvc_pick_of_all_modes(s, bit_depth):
    """The wavefront predicts each leaf's own mode with intra_pred_one;
    vvc predicts all 67 and picks min(mode, 66).  Equal for every mode at
    every size (MIP modes >= 67 included, before MIP replaces them)."""
    import jax.numpy as jnp
    import torch
    from vvc.kernels.intra import predict_all_modes_batch
    from vvc_torch.kernels.intra import predict_modes_batch
    rng = np.random.default_rng(s + bit_depth)
    modes = np.concatenate([np.arange(67), [67, 70, 82]]).astype(np.int32)
    c = rng.integers(0, 1 << bit_depth, size=(modes.size, 4 * s + 3)
                     ).astype(np.int32)
    allm = np.asarray(predict_all_modes_batch(jnp.asarray(c), s, bit_depth))
    want = allm[np.arange(modes.size), np.minimum(modes, 66)]
    got = predict_modes_batch(torch.from_numpy(c), torch.from_numpy(modes),
                              s, bit_depth)
    np.testing.assert_array_equal(got.numpy(), want)

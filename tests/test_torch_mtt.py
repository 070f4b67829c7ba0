"""Slice 2c of the port — the MTT lattice (QT/BT/TT), ISP, MRL and
dependent quantization in lossy All-Intra — against vvc on the CPU.

  * the plain twins of the rect kernels: reference lines, 67-mode and
    one-mode prediction with the wide-angle remap, W×H and 4-point
    transforms, the fused quantise / level-rate / dequantise pass;
  * the search's compositions: eval_isp_dir, eval_mid_plane and
    eval_size_plane at rect shapes, and the whole eval_all_sizes vector
    with the MTT lattice and ISP (single frame and vvc's vmapped 2-tile
    program, 8 and 10 bit, QP 22 and 37, and 10-bit binary noise at QP 57
    and 63 where the SSE sums pass 2^24);
  * encode_sequence with mtt and isp (and mrl and dep_quant) byte-equal to
    vvc's, single tile and 2 tile columns, vvc's decoder checking every
    picture hash; Encoder.encode_frame's leaves include rect, TT-mid, ISP
    and MRL leaves; the dependent-quantization oracles.

Tolerance: exact — integers equal, float32 costs and rates bit for bit.
The whole-program tests compile vvc's MTT + ISP search (about 70 s each
on a CPU core, once per program variant and worker process)."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from vvc.enc import rdo as ref
from vvc.io.synth import synth_frame
from vvc.io.yuv import Frame

from tests.test_torch_rdo import (  # noqa: F401
    _one_torch_thread, release_jax_programs)

# torch and vvc_torch are imported inside the tests, so that a test worker
# that never runs them does not load torch beside JAX.

W, H = 128, 64
LATTICE = ref._candidate_shapes(64, 8, True)
RECT = tuple(s for s in LATTICE if s[0] != s[1])
# the ISP sub-TUs (w, h) of the lattice's shapes with both sides 8..32
ISP_SUBS = ((8, 4), (16, 4), (32, 4), (4, 8), (4, 16), (4, 32), (16, 8),
            (32, 8), (8, 16), (8, 32), (8, 8))


def tt_content(w: int, h: int, seed: int, bit_depth: int = 8):
    """Luma where TT, BT, ISP and MRL leaves win — 16-high textured bands
    at y ≡ 8 (mod 32), the TT_H middle child (vvc's
    tests/test_mtt.py:248) — with synth_frame's chroma; (y, cb, cr)
    int32 at `bit_depth`."""
    rng = np.random.default_rng(seed)
    y = np.full((h, w), 90, np.int64)
    for by in range(0, h, 32):
        for bx in range(0, w, 32):
            y[by:by + 32, bx:bx + 32] = rng.integers(60, 120)
            y[by + 8:by + 24, bx:bx + 32] = rng.integers(140, 220, (16, 32))
    f = synth_frame(w, h, seed)
    sh = bit_depth - 8
    return tuple(np.ascontiguousarray(p.astype(np.int32) << sh)
                 for p in (y, f.cb, f.cr))


def isp_content(w: int, h: int, seed: int, bit_depth: int = 8):
    """A noisy diagonal gradient, where ISP wins often (vvc's
    tests/test_isp.py:45), with synth_frame's chroma."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    y = ((xx * 3 + yy * 2) % 256 + rng.integers(-8, 9, (h, w))).clip(0, 255)
    f = synth_frame(w, h, seed)
    sh = bit_depth - 8
    return tuple(np.ascontiguousarray(p.astype(np.int32) << sh)
                 for p in (y, f.cb, f.cr))


def noise_content(w: int, h: int, seed: int):
    """10-bit binary noise (0 / 1023): at QP 57..63 most of it stays
    uncoded, and the SSE of most blocks passes 2^24."""
    r = np.random.default_rng(500 + seed)
    y = r.integers(0, 2, (h, w)) * 1023
    if seed % 2:
        y = np.kron(r.integers(0, 2, (h // 4, w // 4)),
                    np.ones((4, 4), np.int64)) * 1023
    cb = r.integers(0, 2, (h // 2, w // 2)) * 1023
    cr = r.integers(0, 1024, (h // 2, w // 2))
    return tuple(np.ascontiguousarray(p, dtype=np.int32) for p in (y, cb, cr))


@pytest.fixture(scope="module")
def port():
    from vvc_torch.enc import rdo
    return rdo


# ---------------------------------------------------------------------------
# The rect kernels' plain twins
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bit_depth", (8, 10))
def test_ref_lines_rect_equal(port, bit_depth):
    """build_ref_lines_device_rect at every rect lattice and ISP shape, on
    the shape's grid and at random positions, frame edges included."""
    import torch
    rng = np.random.default_rng(bit_depth)
    plane = rng.integers(0, 1 << bit_depth, (H, W)).astype(np.int32)
    fn = jax.jit(ref.build_ref_lines_device_rect,
                 static_argnames=("w", "h", "bit_depth"))
    for w, h in sorted(set(RECT) | {s for s in ISP_SUBS if s[0] != s[1]}):
        gy, gx = np.mgrid[0:H:h, 0:W:w]
        xs = np.concatenate([gx.ravel(), rng.integers(0, W, 40), [0, 0, 3]])
        ys = np.concatenate([gy.ravel(), rng.integers(0, H, 40), [0, 5, 0]])
        xs, ys = xs.astype(np.int32), ys.astype(np.int32)
        want = np.asarray(fn(jnp.asarray(plane), jnp.asarray(xs),
                             jnp.asarray(ys), w=w, h=h, bit_depth=bit_depth))
        got = port.build_ref_lines_device_rect(
            torch.from_numpy(plane), torch.from_numpy(xs),
            torch.from_numpy(ys), w, h, bit_depth).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"{w}x{h}")


@pytest.mark.parametrize("bit_depth", (8, 10))
def test_predict_all_modes_rect_equal(bit_depth):
    """predict_all_modes_batch_rect (67 modes, wide-angle remap) at the ten
    rect shapes of the lattice, on random and on flat reference lines."""
    import torch
    from vvc.kernels import intra as ref_intra
    from vvc_torch.kernels import intra
    rng = np.random.default_rng(10 + bit_depth)
    fn = jax.jit(ref_intra.predict_all_modes_batch_rect,
                 static_argnames=("w", "h", "bit_depth"))
    for w, h in RECT:
        refs = rng.integers(0, 1 << bit_depth,
                            (9, 2 * h + 2 * w + 3)).astype(np.int32)
        refs[:2] = refs[:2, :1]
        want = np.asarray(fn(jnp.asarray(refs), w=w, h=h,
                             bit_depth=bit_depth))
        got = intra.predict_all_modes_batch_rect(torch.from_numpy(refs), w,
                                                 h, bit_depth).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"{w}x{h}")


def test_predict_modes_rect_equal_wide_angle():
    """predict_modes_batch_rect (one mode per block) at the rect ISP
    sub-TU shapes, 8 and 10 bit, with planar, DC, every angular mode and
    in particular the modes the wide-angle remap moves (2..15 on wide
    blocks, 53..66 on tall ones)."""
    import torch
    from vvc.kernels import intra as ref_intra
    from vvc_torch.kernels import intra
    rng = np.random.default_rng(3)
    fn = jax.jit(ref_intra.predict_modes_batch_rect,
                 static_argnames=("w", "h", "bit_depth"))
    for bit_depth in (8, 10):
        for w, h in (s for s in ISP_SUBS if s[0] != s[1]):
            modes = np.concatenate([np.arange(67), np.arange(2, 16),
                                    np.arange(53, 67)]).astype(np.int32)
            refs = rng.integers(0, 1 << bit_depth, (
                len(modes), 2 * h + 2 * w + 3)).astype(np.int32)
            want = np.asarray(fn(jnp.asarray(refs), jnp.asarray(modes), w=w,
                                 h=h, bit_depth=bit_depth))
            got = intra.predict_modes_batch_rect(
                torch.from_numpy(refs), torch.from_numpy(modes), w, h,
                bit_depth).numpy()
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"{w}x{h} {bit_depth}")
            remapped = [m for m in range(2, 67)
                        if ref_intra.wide_angle_remap(m, w, h) != m]
            assert remapped


def test_rect_transforms_equal():
    """fwd/inv_transform_batch at every rect and 4-point shape of the
    path: the MTS pairs where both sides are 8..32, ISP's implicit pairs,
    DCT2 with a 64-point side; 8 and 10 bit."""
    import torch
    from vvc.kernels import transform as ref_tr
    from vvc.kernels.isp import isp_tr_types
    from vvc_torch.kernels import transform
    rng = np.random.default_rng(5)
    fwd = jax.jit(ref_tr.fwd_transform_batch,
                  static_argnames=("bit_depth", "tr_h", "tr_v"))
    inv = jax.jit(ref_tr.inv_transform_batch,
                  static_argnames=("bit_depth", "tr_h", "tr_v"))
    for w, h in sorted(set(RECT) | set(ISP_SUBS)):
        pairs = {isp_tr_types(w, h), (0, 0)}
        if 8 <= w <= 32 and 8 <= h <= 32:
            pairs |= set(transform.MTS_TR)
        for bit_depth in (8, 10):
            lim = 1 << bit_depth
            x = rng.integers(-lim + 1, lim, (6, h, w)).astype(np.int32)
            for th, tv in sorted(pairs):
                kw = dict(bit_depth=bit_depth, tr_h=int(th), tr_v=int(tv))
                want = np.asarray(fwd(jnp.asarray(x), **kw))
                got = transform.fwd_transform_batch(
                    torch.from_numpy(x), bit_depth, th, tv).numpy()
                np.testing.assert_array_equal(got, want,
                                              err_msg=f"fwd {w}x{h}")
                want_i = np.asarray(inv(jnp.asarray(want), **kw))
                got_i = transform.inv_transform_batch(
                    torch.from_numpy(want.copy()), bit_depth, th, tv).numpy()
                np.testing.assert_array_equal(got_i, want_i,
                                              err_msg=f"inv {w}x{h}")


@pytest.mark.parametrize("intra", (True, False), ids=["intra", "inter"])
def test_quant_rate_rect_equal(intra):
    """quant_rate at the rect and ISP shapes: the dequantised block equals
    vvc's dequant_batch(quant_batch(·)) (dead zone 171/512 intra, 85/512
    inter) at QP 0..63 in steps of 7, and the rate is bit-equal to vvc's
    level_bits_jnp summed in the order its search program gives the shape
    (`rate_order`; the order itself is held by the whole-program vector
    tests below)."""
    import torch
    from vvc.cabac.rates import level_bits_jnp
    from vvc.kernels import quant as ref_q
    from vvc_torch.kernels import quant
    rng = np.random.default_rng(7)
    qb = jax.jit(ref_q.quant_batch, static_argnames=("bit_depth", "intra"))
    dq = jax.jit(ref_q.dequant_batch, static_argnames=("bit_depth",))
    bits = jax.jit(lambda lv: level_bits_jnp(jnp.abs(lv)))
    for w, h in sorted(set(RECT) | set(ISP_SUBS)):
        c = rng.integers(-32768, 32768, (8, h, w)).astype(np.int32)
        c[:5] >>= 9
        for qp in range(0, 64, 7):
            lev = qb(jnp.asarray(c), jnp.int32(qp), bit_depth=10,
                     intra=intra)
            want_d = np.asarray(dq(lev, jnp.int32(qp), bit_depth=10))
            rate, deq = quant.quant_rate(torch.from_numpy(c), qp, 10,
                                         intra=intra)
            np.testing.assert_array_equal(deq.numpy(), want_d)
            want_r = quant.xla_block_sum(
                torch.from_numpy(np.asarray(bits(lev))),
                **quant.rate_order(h, w))
            np.testing.assert_array_equal(rate.numpy().view(np.int32),
                                          want_r.numpy().view(np.int32),
                                          err_msg=f"{w}x{h} qp {qp}")


def test_exp2_table_matches_jax_bits(port):
    """The ISP stage's λ·2.5 is E·float32(0.57·2.5) in vvc's program, E =
    2^((qp−12)/3): the port's E table holds XLA's float32 bits, and
    0.57·E is the λ table."""
    e = np.asarray(jax.jit(lambda qp: jnp.exp2(
        (qp.astype(jnp.float32) - 12.0) / 3.0))(jnp.arange(64)))
    np.testing.assert_array_equal(
        e.view(np.uint32), np.asarray(port.EXP2_F32_BITS, np.uint32))
    lam = np.asarray(port.LAMBDA_F32_BITS, np.uint32).view(np.float32)
    np.testing.assert_array_equal(np.float32(0.57) * e, lam)


# ---------------------------------------------------------------------------
# The search's compositions
# ---------------------------------------------------------------------------


def test_eval_isp_dir_equal(port):
    """eval_isp_dir (both directions; rect and square sub-TUs) bit-equal
    to vvc's jitted eval_isp_dir on the modes of a decided plane."""
    import torch
    y, _, _ = isp_content(W, H, 2)
    fn = jax.jit(ref.eval_isp_dir, static_argnames=(
        "w", "h", "bit_depth", "direction"))
    rng = np.random.default_rng(9)
    for w, h in ((16, 8), (8, 32), (32, 16), (8, 8)):
        gy, gx = np.mgrid[0:H:h, 0:W:w]
        xs, ys = gx.ravel().astype(np.int32), gy.ravel().astype(np.int32)
        modes = rng.integers(0, 67, xs.shape[0]).astype(np.int32)
        for d in (1, 2):
            want = np.asarray(fn(jnp.asarray(y), jnp.asarray(xs),
                                 jnp.asarray(ys), w=w, h=h,
                                 modes=jnp.asarray(modes), qp=jnp.int32(27),
                                 bit_depth=8, direction=d))
            got = port.eval_isp_dir(torch.from_numpy(y), torch.from_numpy(xs),
                                    torch.from_numpy(ys), w, h,
                                    torch.from_numpy(modes), 27, 8, d).numpy()
            np.testing.assert_array_equal(got.view(np.int32),
                                          want.view(np.int32),
                                          err_msg=f"{w}x{h} dir {d}")


@pytest.mark.usefixtures("release_jax_programs")
def test_eval_mid_plane_and_size_plane_equal(port):
    """eval_mid_plane for TH and TV descriptors and eval_size_plane at
    rect shapes with ISP: the 6-tuples bit-equal to vvc's jitted ones."""
    import torch
    y, _, _ = tt_content(W, H, 1)
    mid = jax.jit(ref.eval_mid_plane, static_argnames=(
        "desc", "bit_depth", "lossless", "lfnst_enabled"))
    for desc in (("TH", 32), ("TV", 8)):
        want = mid(jnp.asarray(y), desc, jnp.int32(32), 8, False, True)
        got = port.eval_mid_plane(torch.from_numpy(y), desc, 32, 8, False,
                                  True)
        for g, w_ in zip(got, want):
            np.testing.assert_array_equal(g.numpy().view(np.int32),
                                          np.asarray(w_).view(np.int32),
                                          err_msg=str(desc))
    plane = jax.jit(ref.eval_size_plane, static_argnames=(
        "size", "bit_depth", "ny", "nx", "h", "isp_enabled"))
    for w, h in ((32, 16), (8, 32), (64, 16)):
        want = plane(jnp.asarray(y), size=w, qp=jnp.int32(32), bit_depth=8,
                     ny=H // h, nx=W // w, h=h, isp_enabled=True)
        got = port.eval_size_plane(torch.from_numpy(y), w, 32, 8, H // h,
                                   W // w, h=h, isp_enabled=True)
        for g, w_ in zip(got, want):
            np.testing.assert_array_equal(g.numpy().view(np.int32),
                                          np.asarray(w_).view(np.int32),
                                          err_msg=f"{w}x{h}")


def _vectors(port, planes, qp, bit_depth, tiles):
    """vvc's and the port's packed search vectors (MTT lattice, ISP, LFNST
    and the chroma decision, as encode_sequence runs them)."""
    import torch
    y, cb, cr = planes
    if tiles:
        wt = W // 2
        vec = ref.pack_planes(np.stack([y[:, :wt], y[:, wt:]]),
                              np.stack([cb[:, :wt // 2], cb[:, wt // 2:]]),
                              np.stack([cr[:, :wt // 2], cr[:, wt // 2:]]))
        want = np.asarray(ref.eval_all_sizes_frames(
            jnp.asarray(vec), LATTICE, jnp.int32(qp), bit_depth, wt, H, 2,
            False, True, True, True))
        got = port.eval_all_sizes_frames(
            torch.from_numpy(vec), LATTICE, qp, bit_depth, wt, H, 2, False,
            True, True, True).numpy()
        return want, got, wt
    vec = ref.pack_planes(y, cb, cr)
    want = np.asarray(ref.eval_all_sizes(jnp.asarray(vec), LATTICE,
                                         jnp.int32(qp), bit_depth, W, H,
                                         False, True, True, True))
    got = port.eval_all_sizes(torch.from_numpy(vec), LATTICE, qp, bit_depth,
                              W, H, False, True, True, True).numpy()
    return want, got, W


@pytest.mark.usefixtures("release_jax_programs")
@pytest.mark.parametrize("bit_depth,tiles", [
    (8, False), pytest.param(8, True, marks=pytest.mark.slow),
    pytest.param(10, False, marks=pytest.mark.slow),
    pytest.param(10, True, marks=pytest.mark.slow)],
    ids=["8bit-single", "8bit-2tiles", "10bit-single", "10bit-2tiles"])
def test_eval_all_sizes_mtt_isp_bit_equal(port, monkeypatch, bit_depth,
                                          tiles):
    """The whole packed search vector with the MTT lattice (14 shapes and
    the 6 TT mid planes) and ISP, bit-equal to vvc's single-frame program
    or its vmapped 2-tile program, at QP 22 and 37 on MTT/ISP content and
    on synth_frame; at 10 bit also on binary noise at QP 57 and 63, where
    the SSE of most blocks passes 2^24 and takes XLA's per-site order.
    Each case compiles a vvc program of its own (about 75 s alone, twice
    that beside five other workers): the 2-tile and 10-bit ones are
    `slow`; the 2-tile stream test below holds the 8-bit tile program
    end to end."""
    import torch
    big = []
    sse_f32 = port._sse_f32

    def counted(d, **order):
        dl = d.to(torch.int64)
        big.append(int(((dl * dl).sum(dim=(1, 2)) >= 1 << 24).sum()))
        return sse_f32(d, **order)

    monkeypatch.setattr(port, "_sse_f32", counted)
    f = synth_frame(W, H, 1)
    sh = bit_depth - 8
    cases = [(tt_content(W, H, 1, bit_depth), 22),
             (isp_content(W, H, 3, bit_depth), 37),
             (tuple(p.astype(np.int32) << sh for p in (f.y, f.cb, f.cr)), 37)]
    if bit_depth == 10:
        cases += [(noise_content(W, H, 0), 57), (noise_content(W, H, 1), 63)]
    wins = {"rect": 0, "isp": 0, "mts": 0, "mid": 0}
    for planes, qp in cases:
        want, got, wt = _vectors(port, planes, qp, bit_depth, tiles)
        assert got.dtype == np.int32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want, err_msg=f"qp {qp}")
        for row in want.reshape(-1, want.shape[-1]):
            res = port.unpack_results(row, LATTICE, wt, H)
            for sh_, r in res.items():
                wins["isp"] += int((r[5] > 0).sum())
                wins["mts"] += int((r[2] > 0).sum())
                if isinstance(sh_[0], str):
                    wins["mid"] += r[0].size
                elif sh_[0] != sh_[1]:
                    wins["rect"] += r[0].size
    assert all(v > 0 for v in wins.values()), wins
    if bit_depth == 10:
        assert sum(big) > 1000


# ---------------------------------------------------------------------------
# Streams
# ---------------------------------------------------------------------------


def _frames(n: int):
    """TT-friendly pictures (seeds 1, 0, ...) as vvc and port Frames."""
    from vvc_torch.io.yuv import Frame as PortFrame
    planes = [tt_content(W, H, (t + 1) % n) for t in range(n)]
    return ([Frame(*p, 8) for p in planes],
            [PortFrame(*(a.copy() for a in p), 8) for p in planes])


@pytest.mark.usefixtures("release_jax_programs")
@pytest.mark.parametrize("cols", (1, 2), ids=["single_tile", "two_tile_cols"])
def test_mtt_isp_stream_byte_equal_and_decodes(cols):
    """encode_sequence(frames, qp=32, mtt=True, isp=True) and the same with
    mrl=True, dep_quant=True: byte-equal to vvc's (2 frames of 128×64),
    equal recons, vvc's decoder decodes vvc's stream with every MD5 OK,
    and the picked leaves include rect, TT-mid, ISP and (with mrl) MRL
    leaves."""
    from vvc.dec.decoder import decode_stream
    from vvc.enc.encoder import encode_sequence as ref_encode
    from vvc_torch.enc.encoder import encode_sequence as port_encode
    frames, port_frames = _frames(2)
    for kw in ({"mtt": True, "isp": True},
               {"mtt": True, "isp": True, "mrl": True, "dep_quant": True}):
        want, want_rec, _ = ref_encode(frames, qp=32, num_tile_cols=cols,
                                       **kw)
        got, got_rec, stats = port_encode(port_frames, qp=32,
                                          num_tile_cols=cols, device="cpu",
                                          **kw)
        assert got == want, kw
        for a, b in zip(want_rec, got_rec):
            for p, q in ((a.y, b.y), (a.cb, b.cb), (a.cr, b.cr)):
                np.testing.assert_array_equal(p, q)
        dec, info = decode_stream(want)
        assert len(info["hash_ok"]) == 2 and all(info["hash_ok"])
        assert all(25 < s["psnr_y"] < 60 for s in stats)
        kinds = {k: sum(s["leaf_kinds"][k] for s in stats)
                 for k in ("rect", "tt_mid", "isp", "mrl")}
        assert all(kinds[k] > 0 for k in ("rect", "tt_mid", "isp")), kinds
        assert (kinds["mrl"] > 0) == kw.get("mrl", False), kinds


@pytest.mark.usefixtures("release_jax_programs")
def test_encode_frame_mtt_isp_mrl_dq_leaves():
    """Encoder.encode_frame with SPS(max_mtt_depth_intra=2, isp, mrl,
    dep_quant) and the default lossy tools: NALs and recons equal to
    vvc's, MD5 OK, and the picked leaves include rect, TT-mid, ISP and
    MRL leaves."""
    from tests.test_torch_encode import _encode_frames_equal_and_decode
    frames, port_frames = _frames(2)
    sps_kw = dict(deblocking=True, mts_intra=True, mip=True, lfnst=True,
                  cclm=True, sao=True, alf=True, max_mtt_depth_intra=2,
                  isp=True, mrl=True, dep_quant=True)
    out = _encode_frames_equal_and_decode(sps_kw, W, H, 32, 1, frames,
                                          port_frames)
    leaves = [l for _, lv in out for l in lv]
    assert any(l.w != l.h for l in leaves)                    # rect
    assert any(l.isp > 0 for l in leaves)                     # ISP
    assert any(l.mrl > 0 for l in leaves)                     # MRL
    # a TT mid leaf: 16 high at y ≡ 8 (mod 32), or 16 wide at x ≡ 8
    assert any((l.h == 16 and l.y0 % 32 == 8) or (l.w == 16 and l.x0 % 32 == 8)
               for l in leaves)


def test_depquant_oracles_equal():
    """Dependent quantization: the port's quant/dequant (the recon core's
    trellis) equal the numpy oracles and vvc's, at rect and square
    shapes."""
    from vvc.kernels import depquant as ref_dq
    from vvc_torch.kernels import depquant
    rng = np.random.default_rng(11)
    for w, h in ((8, 8), (16, 8), (4, 16), (32, 32), (64, 16)):
        c = (rng.integers(-4096, 4097, (h, w)) >> rng.integers(0, 6)
             ).astype(np.int32)
        for qp in (22, 32, 37):
            lev = depquant.quant_depquant_np(c, qp, 8)
            np.testing.assert_array_equal(lev,
                                          ref_dq.quant_depquant_np(c, qp, 8))
            deq = depquant.dequant_depquant_np(lev, qp, 8)
            np.testing.assert_array_equal(
                deq, ref_dq.dequant_depquant_np(lev, qp, 8))
            native = depquant._native
            try:
                depquant._native = lambda: None
                np.testing.assert_array_equal(
                    depquant.quant_depquant_np(c, qp, 8), lev)
                np.testing.assert_array_equal(
                    depquant.dequant_depquant_np(lev, qp, 8), deq)
            finally:
                depquant._native = native


@pytest.mark.slow
@pytest.mark.usefixtures("release_jax_programs")
def test_ldp_i_picture_mtt_isp_stream_byte_equal():
    """The I picture of an LDP GOP reaches the MTT + ISP search through
    encode_frame: 4 frames of the motion clip, mtt and isp on, byte-equal
    to vvc's with every MD5 OK."""
    from vvc.dec.decoder import decode_stream
    from vvc.enc.encoder import encode_sequence as ref_encode
    from vvc_torch.enc.encoder import encode_sequence as port_encode
    from vvc_torch.io.synth import motion_clip
    clip = motion_clip(4, W, H)
    want = ref_encode([Frame(f.y.copy(), f.cb.copy(), f.cr.copy(), 8)
                       for f in clip], qp=32, mode="ldp", mtt=True,
                      isp=True)[0]
    got = port_encode(clip, qp=32, mode="ldp", mtt=True, isp=True,
                      device="cpu")[0]
    assert got == want
    _, info = decode_stream(want)
    assert len(info["hash_ok"]) == 4 and all(info["hash_ok"])

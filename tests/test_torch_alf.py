"""The port's ALF and CC-ALF (vvc_torch.kernels.alf, vvc_torch.enc.alf_enc,
vvc_torch.kernels.ccalf, vvc_torch.hls.aps) against vvc's on the CPU.

alf_stats_dev: the port sums exactly and rounds once, except B100 from
4096 grid points on, which takes the float32 order of the tiled GEMV
XLA-CPU lowers vvc's Fᵀt dot to, and is held bit-equal to vvc's.  vvc's
other float32 sums (A100, an Eigen contraction whose order the port does
not reproduce, and sse0) round along the way.  So npx and B100 are held
bit-equal, the port's A100 and sse0 equal the exactly rounded sums bit
for bit, and they are held to vvc's within a relative 2^-20 of their
scale (A: √(A_ii·A_jj), the Cauchy–Schwarz bound of |A_ij|; sse0: its
largest entry).
Every decision that rests on them — the luma filters, clips, class map
and CTU flags, the chroma filter — is held equal to vvc's (ROADMAP §3;
tests/sweep_torch_alf_decisions.py sweeps more pictures).  The host
parts (classification, filter application, CC-ALF, the APS bytes) are
exact."""
import jax.numpy as jnp
import numpy as np
import pytest

from vvc.enc import alf_enc as ref_enc
from vvc.hls import aps as ref_aps
from vvc.io.synth import synth_frame
from vvc.kernels import alf as ref
from vvc.kernels import ccalf as ref_cc

from tests.test_torch_rdo import _one_torch_thread  # noqa: F401

# torch and vvc_torch are imported inside the tests, so that a test worker
# that never runs them does not load torch beside JAX.

TOL = 2.0 ** -20


def picture(w, h, bit_depth, amp, seed, t=0):
    """Synthetic planes (orig) and orig + seeded uniform noise (recon)."""
    rng = np.random.default_rng(seed)
    f = synth_frame(w, h, t)
    mx = (1 << bit_depth) - 1
    orig = [p.astype(np.int32) << (bit_depth - 8) for p in (f.y, f.cb, f.cr)]
    rec = [np.clip(p + rng.integers(-amp, amp + 1, p.shape), 0, mx)
           .astype(np.int32) for p in orig]
    return orig, rec


def _exact_stats(o, r, cls4, tr4):
    """vvc's statistics as exact integers (numpy int64)."""
    h, w = o.shape
    p = np.pad(r.astype(np.int64), 3, mode="edge")
    c = r.astype(np.int64)[::2, ::2]
    F = np.stack([(p[3 + a[0]:3 + a[0] + h:2, 3 + a[1]:3 + a[1] + w:2]
                   + p[3 + b[0]:3 + b[0] + h:2, 3 + b[1]:3 + b[1] + w:2]
                   - 2 * c).ravel() for a, b in ref.diamond_pairs(3)])
    t = (o.astype(np.int64)[::2, ::2] - c).ravel()
    hs, ws = c.shape
    cls = np.repeat(np.repeat(cls4, 2, 0), 2, 1)[:hs, :ws].ravel()
    key = cls * 4 + np.repeat(np.repeat(tr4, 2, 0), 2, 1)[:hs, :ws].ravel()
    A = np.zeros((100, 12, 12), np.int64)
    B = np.zeros((100, 12), np.int64)
    for g in np.unique(key):
        fg = F[:, key == g]
        A[g] = fg @ fg.T
        B[g] = fg @ t[key == g]
    sse0 = np.bincount(cls, t * t, minlength=25)
    npx = np.bincount(cls, minlength=25)
    return A, B, sse0, npx


@pytest.mark.parametrize("w,h,bit_depth,amp", [
    (416, 240, 8, 8), (416, 240, 10, 20), (1920, 1080, 8, 20)],
    ids=["416x240-8bit", "416x240-10bit", "1080p-8bit"])
def test_alf_stats_exact_and_near_vvc(w, h, bit_depth, amp):
    import torch
    from vvc_torch.kernels import alf as port
    orig, rec = picture(w, h, bit_depth, amp, w + bit_depth)
    o, r = orig[0], rec[0]
    cls4, tr4 = ref.alf_classify_np(r, bit_depth)
    want = [np.asarray(x, np.float64) for x in ref.alf_stats_dev(
        *(jnp.asarray(a) for a in (o, r, cls4, tr4)))]
    got = port.alf_stats_dev(*(torch.from_numpy(a)
                               for a in (o, r, cls4, tr4)))
    assert all(g.dtype == torch.float32 for g in got)
    got = [g.numpy() for g in got]
    exact = _exact_stats(o, r, cls4, tr4)
    for i in (0, 2, 3):
        np.testing.assert_array_equal(got[i], exact[i].astype(np.float32))
    np.testing.assert_array_equal(got[3], want[3])             # npx
    # B100 (Fᵀt) bit for bit: vvc's GEMV order
    np.testing.assert_array_equal(got[1].view(np.int32),
                                  want[1].astype(np.float32).view(np.int32))
    A = got[0].astype(np.float64)
    diag = np.sqrt(np.einsum("gii->gi", np.abs(want[0])))
    assert (np.abs(A - want[0])
            <= TOL * diag[:, :, None] * diag[:, None, :]).all()
    scale = np.abs(want[2]).max(axis=-1, keepdims=True)
    assert (np.abs(got[2] - want[2]) <= TOL * scale).all()
    if (w, bit_depth) != (416, 8):
        # the sums pass 2^24 and vvc's float32 order shows
        assert (A != want[0]).any()


@pytest.mark.parametrize("amp", (40, 160))
def test_alf_b100_bit_equal_1080p_10bit(amp):
    """B100 at 1080p, 10 bit, on the picture family of
    tests/sweep_torch_alf_decisions.py: bit-equal to vvc's, where the
    exactly rounded sums differ from vvc's in some entries (the order
    matters there)."""
    import torch
    from vvc_torch.kernels import alf as port
    orig, rec = picture(1920, 1080, 10, amp, 0, t=3)
    o, r = orig[0], rec[0]
    cls4, tr4 = ref.alf_classify_np(r, 10)
    want = np.asarray(ref.alf_stats_dev(
        *(jnp.asarray(a) for a in (o, r, cls4, tr4)))[1], np.float32)
    got = port.alf_stats_dev(*(torch.from_numpy(a)
                               for a in (o, r, cls4, tr4)))[1].numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    exact = _exact_stats(o, r, cls4, tr4)[1].astype(np.float32)
    assert (exact != want).any()


def test_alf_stats_grid():
    """The CUDA wrapper's host rule: the grid, the GEMV order from 4096
    grid points on (128×128 reaches it, 112×146 stops 8 short), and maps
    that must cover the grid."""
    from vvc_torch.kernels import alf as port
    assert port._stats_grid(128, 128, 32, 32) == (4096, True)
    assert port._stats_grid(112, 146, 28, 37) == (4088, False)
    assert port._stats_grid(1080, 1920, 270, 480) == (518400, True)
    with pytest.raises(ValueError, match="cover"):
        port._stats_grid(112, 146, 28, 36)
    with pytest.raises(ValueError, match="multiple of 8"):
        port._stats_grid(114, 146, 29, 37)          # 57 × 73 points


def _alf_fields(res):
    luma, flags, chroma, delta = res
    return ((None if luma is None else tuple(np.asarray(x).tolist()
                                             for x in luma)),
            tuple(sorted(flags.items())),
            None if chroma is None else np.asarray(chroma).tolist(),
            None if delta is None else np.asarray(delta).tobytes())


@pytest.mark.parametrize("bit_depth,amp,qp", [(8, 3, 32), (8, 12, 37),
                                              (10, 20, 32), (10, 40, 22)])
def test_decide_alf_frame_equal(bit_depth, amp, qp):
    """Luma filters, clips, class map, CTU flags, the precomputed luma
    delta and the chroma filter equal vvc's on 416×240 pictures."""
    from vvc_torch.enc import alf_enc as port_enc
    orig, rec = picture(416, 240, bit_depth, amp, amp, t=amp % 3)
    want = ref_enc.decide_alf_frame(orig, rec, qp, bit_depth, 64)
    got = port_enc.decide_alf_frame(orig, rec, qp, bit_depth, 64,
                                    device="cpu")
    assert _alf_fields(got) == _alf_fields(want)
    assert got[0] is not None and any(got[1].values())


@pytest.mark.parametrize("bit_depth", (8, 10))
def test_alf_host_parts_equal(bit_depth):
    """The native classification equals vvc's numpy oracle; the classified
    delta, the gated and the plain filter application equal vvc's."""
    from vvc_torch.kernels import alf as port
    orig, rec = picture(256, 128, bit_depth, 10, bit_depth)
    r = rec[0]
    cls4, tr4 = port.alf_classify(r, bit_depth)
    want_c, want_t = ref.alf_classify_np(r, bit_depth)
    np.testing.assert_array_equal(cls4, want_c)
    np.testing.assert_array_equal(tr4, want_t)
    rng = np.random.default_rng(bit_depth)
    coeffs = rng.integers(-20, 21, (3, 12)).astype(np.int32)
    clips = np.array([0, 1 << (bit_depth - 3), 1 << (bit_depth - 5)],
                     np.int32)
    fmap = rng.integers(0, 3, 25).astype(np.int32)
    delta = port.alf_delta_classified(r, coeffs, clips, fmap, cls4, tr4)
    np.testing.assert_array_equal(delta, ref.alf_delta_classified_np(
        r, coeffs, clips, fmap, cls4, tr4))
    flags = {(x, y): (x + y) % 128 == 0 for y in range(0, 128, 64)
             for x in range(0, 256, 64)}
    a, b = r.copy(), r.copy()
    port.apply_delta_gated(a, delta, bit_depth, flags, 64)
    ref.apply_delta_gated(b, delta, bit_depth, flags, 64)
    np.testing.assert_array_equal(a, b)
    cc = rng.integers(-30, 31, 6).astype(np.int32)
    a, b = rec[1].copy(), rec[1].copy()
    port.apply_alf_plane(a, cc, 2, bit_depth)
    ref.apply_alf_plane(b, cc, 2, bit_depth)
    np.testing.assert_array_equal(a, b)


def cosited_picture(w, h, bit_depth, amp, seed):
    """Chroma that carries the luma's co-sited detail (CC-ALF corrects its
    coding error from the luma): Cb = Y[::2, ::2], Cr its complement."""
    orig, rec = picture(w, h, bit_depth, amp, seed)
    mx = (1 << bit_depth) - 1
    orig[1] = orig[0][::2, ::2].copy()
    orig[2] = mx - orig[1]
    rng = np.random.default_rng(seed + 1)
    for c in (1, 2):
        smooth = (orig[c] + np.roll(orig[c], 1, 1)) // 2
        rec[c] = np.clip(smooth + rng.integers(-2, 3, smooth.shape), 0,
                         mx).astype(np.int32)
    return orig, rec


@pytest.mark.parametrize("bit_depth", (8, 10))
def test_ccalf_and_aps_equal(bit_depth):
    """derive_ccalf and apply_ccalf_delta equal vvc's (on co-sited content
    a filter on both planes; on noise whatever vvc finds), and
    write_aps_alf gives vvc's bytes for the parameters of a picture."""
    from vvc_torch.enc import alf_enc as port_enc
    from vvc_torch.hls import aps as port_aps
    from vvc_torch.kernels import ccalf as port_cc
    found = []
    for orig, rec in (cosited_picture(128, 64, bit_depth, 6, 1),
                      picture(128, 64, bit_depth, 6, 2)):
        luma, _, chroma, _ = port_enc.decide_alf_frame(
            orig, rec, 32, bit_depth, 64, device="cpu")
        ccs = []
        for c in (1, 2):
            got = port_cc.derive_ccalf(orig[c], rec[c], rec[0], bit_depth)
            want = ref_cc.derive_ccalf(orig[c], rec[c], rec[0], bit_depth)
            assert (got is None) == (want is None)
            found.append(got is not None)
            if got is not None:
                np.testing.assert_array_equal(got, want)
                np.testing.assert_array_equal(
                    port_cc.apply_ccalf_delta(rec[c], rec[0], got,
                                              bit_depth),
                    ref_cc.apply_ccalf_delta(rec[c], rec[0], want,
                                             bit_depth))
            ccs.append(got)
        for aps_id in (0, 31):
            assert port_aps.write_aps_alf(aps_id, luma, chroma, *ccs) == \
                ref_aps.write_aps_alf(aps_id, luma, chroma, *ccs)
    assert found[:2] == [True, True]

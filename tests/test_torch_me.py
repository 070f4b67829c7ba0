"""The port's window motion search (vvc_torch.enc.me) against vvc's
(vvc/enc/me.py) on the CPU, one jitted vvc function per test:

  * `prep_ref` ↔ `_prep_ref`: padded and ds4 planes, including sizes that
    are not multiples of 4;
  * `coarse_search` ↔ `_coarse_program`: the grids of sizes 16, 32 and 64
    over two references, on noise and on smooth and flat content, where
    the MV bias and its float32 sums decide, and on a constructed tie;
  * `int_refine` ↔ `_win_centers` + `_gather_windows` + `_int_refine`,
    and `qpel_refine` ↔ `_qpel_refine`, at s = 8, 16, 32 and 64, 8 and
    10 bit: on a shifted texture, on two constructed ties (the first
    minimum wins), and at 10 bit on noise, whose SSE sums pass 2^24 from
    s = 16 on (the float32 order of vvc's sums).

Tolerance: exact — integer outputs equal, float32 costs bit for bit."""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vvc.enc import me as ref

from tests.test_torch_rdo import _one_torch_thread  # noqa: F401

# torch and vvc_torch are imported inside the tests, so that a test worker
# that never runs them does not load torch beside JAX.


@pytest.mark.parametrize("h,w", [(48, 64), (45, 67)])
def test_prep_ref_equal(h, w):
    import torch
    from vvc_torch.enc import me
    plane = np.random.default_rng(h * w).integers(0, 1024, (h, w)).astype(
        np.int32)
    pp, ds = ref._prep_ref(jnp.asarray(plane), h, w)
    tp, td = me.prep_ref(torch.from_numpy(plane))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(pp))
    np.testing.assert_array_equal(td.numpy(), np.asarray(ds))


def _coarse_inputs(kind: str, h4: int, w4: int, rng):
    if kind == "noise":
        return (rng.integers(0, 256, (h4, w4)),
                rng.integers(0, 256, (2, h4, w4)))
    if kind == "flat":                  # every SSE 0: the bias alone
        return (np.full((h4, w4), 77), np.full((2, h4, w4), 77))
    if kind == "tie":
        # flat but for the columns x ≡ 0, 3, 5, 6 (mod 8): a 4-column cell
        # starting at x ≡ 0 sees two of them at dx = 0, one at dx = -1 and
        # +1 (which tie at the same bias) and at least one elsewhere
        ref_p = np.full((2, h4, w4), 77)
        ref_p[:, :, np.isin(np.arange(w4) % 8, (0, 3, 5, 6))] += 9
        return np.full((h4, w4), 77), ref_p
    base = rng.integers(100, 104, (h4 + 8, w4 + 8))     # smooth: near ties
    return (base[4:4 + h4, 4:4 + w4],
            np.stack([base[4 + k:4 + k + h4, 3:3 + w4] for k in (0, 1)]))


@pytest.mark.parametrize("kind", ["noise", "smooth", "flat", "tie"])
def test_coarse_search_equal(kind):
    import torch
    from vvc_torch.enc import me
    h4, w4 = 16, 36                   # not a multiple of 16: padded grids
    yds, refds = (a.astype(np.int32) for a in _coarse_inputs(
        kind, h4, w4, np.random.default_rng(len(kind))))
    want = ref._coarse_program(jnp.asarray(yds), jnp.asarray(refds), h4, w4,
                               ref.COARSE_R)
    got = me.coarse_search(torch.from_numpy(yds), torch.from_numpy(refds))
    for s in (16, 32, 64):
        np.testing.assert_array_equal(got[s].numpy(), np.asarray(want[s]))
    if kind == "flat":                # the bias: zero motion everywhere
        assert all((got[s] == 0).all() for s in (16, 32, 64))
    if kind == "tie":                 # the first of dx = -1, +1 (in ds4)
        g4 = got[16].numpy()
        cx = np.arange(g4.shape[2])
        sel = ((cx % 2) == 0) & (cx > 0) & (4 * cx + 4 < w4)
        assert (g4[:, :h4 // 4, sel, 1] == -4).all()
        assert (g4[:, :h4 // 4, sel, 0] == 0).all()


@partial(jax.jit, static_argnames=("s", "h", "w"))
def _vvc_int(refpad, ob, ys, xs, cy, cx, lam_m, s, h, w):
    cy, cx, sy, sx = ref._win_centers(cy, cx, ys, xs, h, w, s)
    win = ref._gather_windows(refpad, sy, sx, s + 2 * ref.WIN_M)
    iy, ix, w2 = ref._int_refine(win, ob, cy, cx, lam_m, s)
    return iy, ix, w2


@partial(jax.jit, static_argnames=("s", "bit_depth"))
def _vvc_qpel(w2, ob, iy, ix, lam_m, s, bit_depth):
    return ref._qpel_refine(w2, ob, iy, ix, lam_m, s, bit_depth)


H, W = 256, 256


def _content(kind: str, bit_depth: int, s: int, rng):
    """(reference, current) planes [H, W]."""
    mx = (1 << bit_depth) - 1
    if kind == "noise":
        return rng.integers(0, mx + 1, (H, W)), rng.integers(0, mx + 1, (H, W))
    v = mx // 3
    if kind == "tie_int":
        # the picture is flat v but for the first and the last row of every
        # other block row: those blocks see two such rows at dy = 0 and
        # one at dy = -1 and at dy = +1, which tie at the lowest MV bits
        ref_p = np.full((H, W), v)
        y = np.arange(H)
        ref_p[((y // s) % 2 == 0) & ((y % s == 0) | (y % s == s - 1))] += 8
        return ref_p, np.full((H, W), v)
    if kind == "tie_qpel":
        # columns alternate v, v + 8; the block is flat v + 4: the
        # half-pel phases average them exactly, and qx = -2 and +2 tie
        ref_p = np.full((H, W), v)
        ref_p[:, 1::2] += 8
        return ref_p, np.full((H, W), v + 4)
    yy, xx = np.mgrid[0:H + 8, 0:W + 8]
    tex = np.clip(mx * (0.5 + 0.3 * np.sin(xx / 5.0) * np.cos(yy / 7.0))
                  + rng.integers(-3, 4, xx.shape), 0, mx)
    return tex[5:5 + H, 3:3 + W], tex[8:8 + H, 6:6 + W]


@pytest.mark.parametrize("bit_depth", (8, 10))
@pytest.mark.parametrize("s", (8, 16, 32, 64))
def test_int_and_qpel_refine_equal(s, bit_depth):
    import torch
    from vvc_torch.enc import me
    from vvc_torch.enc.rdo import lambda_f32
    _, lam_m = lambda_f32(32)
    kinds = ["texture", "tie_int", "tie_qpel"] + (
        ["noise"] if bit_depth == 10 else [])
    for kind in kinds:
        rng = np.random.default_rng(s * bit_depth + len(kind))
        ref_p, cur = (a.astype(np.int32) for a in _content(kind, bit_depth, s,
                                                           rng))
        ny, nx = H // s, W // s
        ob = cur.reshape(ny, s, nx, s).transpose(0, 2, 1, 3).reshape(-1, s, s)
        ys = (np.repeat(np.arange(ny), nx) * s).astype(np.int32)
        xs = (np.tile(np.arange(nx), ny) * s).astype(np.int32)
        n = ny * nx
        cy = rng.integers(-36, 37, n).astype(np.int32)
        cx = rng.integers(-36, 37, n).astype(np.int32)
        if kind.startswith("tie"):
            cy[:] = 0
            cx[:] = 0
        pp = ref._prep_ref(jnp.asarray(ref_p), H, W)[0]
        iy, ix, w2 = _vvc_int(pp, jnp.asarray(ob), jnp.asarray(ys),
                              jnp.asarray(xs), jnp.asarray(cy),
                              jnp.asarray(cx), jnp.float32(lam_m), s, H, W)
        want = _vvc_qpel(w2, jnp.asarray(ob), iy, ix, jnp.float32(lam_m), s,
                         bit_depth)
        t = torch.from_numpy
        tpp = t(np.array(pp))
        got_i = me.int_refine(tpp, t(ob), t(ys), t(xs), t(cy), t(cx), lam_m,
                              s, H, W)
        np.testing.assert_array_equal(got_i[0].numpy(), np.asarray(iy))
        np.testing.assert_array_equal(got_i[1].numpy(), np.asarray(ix))
        got = me.qpel_refine(tpp, t(ob), t(ys), t(xs), got_i[0], got_i[1],
                             lam_m, s, bit_depth)
        for g, wv in zip(got, want):
            wv = np.asarray(wv)
            if wv.dtype == np.float32:
                np.testing.assert_array_equal(g.numpy().view(np.int32),
                                              wv.view(np.int32))
            else:
                np.testing.assert_array_equal(g.numpy(), wv)
        if kind == "tie_int":         # the first of dy = -1, +1
            sel = ((ys // s) % 2 == 0) & (ys >= s) & (ys + s < H)
            assert sel.any() and (got_i[0].numpy()[sel] == -1).all()
        if kind == "tie_qpel":        # the first of qx = -2, +2
            sel = (xs >= 16) & (xs + s <= W - 16)
            assert sel.any() and (got[1].numpy()[sel] == -2).all()
        if kind == "noise" and s >= 16:   # every SSE passes 2^24
            rb = ref_p.reshape(ny, s, nx, s).transpose(0, 2, 1, 3).reshape(
                -1, s, s)
            d = ob.astype(np.int64) - rb
            assert ((d * d).sum(axis=(1, 2)) >= 1 << 24).all()

"""Slice 4b's affine search and the host inter tools against vvc's on the
CPU:

  * `vvc_torch.kernels.gpm` (numpy) equals vvc's, and the three port
    modules that import it (`kernels.mc`, `enc.mode_decide`,
    `cabac.cu_syntax`) import and reach it;
  * `me.affine_search_plain` ↔ vvc/enc/me.py `affine_search_win` (fed the
    w2 window that vvc's `_int_refine` would return, read by the port from
    the padded reference): cost, da, db and the DCTIF prediction, at
    s = 16, 32, 64 and 8 and 10 bit, on noise and smooth content, on
    near-flat blocks where each stage's rounding of the cost decides the
    last bit; on a
    constructed tie in both stages (flat content, λ = 0: the first
    candidate wins stage 1 and no step moves it); on a block that is the
    bilinear prediction of (da, db) = (4, 0) at s = 16, whose DCTIF offsets
    q0 + dq fall on .5 (round half to even);
  * the invariant the port's integer bilinear rests on: every reachable
    candidate position is a multiple of 1/128 inside the window, so vvc's
    float32 passes are exact;
  * `me.affine_dctif_pred` ↔ `_affine_dctif_pred` at every (qy, qx) in
    [−12, 11]², 8 and 10 bit, with sums ≡ 2048 (mod 4096) (ties of the
    round half to even);
  * streams: LDP with affine on `_warp_frames` of tests/test_affine.py
    (affine leaves chosen), and, marked `slow` (vvc's cold compiles of its
    affine programs take minutes), Random Access GOP 4 with all ten slice-4b
    options on `chip_smoke.tool_clip` (each tool chooses a leaf), byte-equal
    to vvc's and decoded with every picture hash OK.

Tolerance: exact — integers equal, float32 costs bit for bit, bytes."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from vvc.dec.decoder import decode_stream
from vvc.enc import me as ref
from vvc.enc.encoder import encode_sequence as ref_encode
from vvc.io.yuv import Frame

from chip_smoke import tool_clip
from tests.test_affine import _warp_frames
from tests.test_torch_rdo import (  # noqa: F401
    _one_torch_thread, release_jax_programs)

# torch and vvc_torch are imported inside the tests, so that a test worker
# that never runs them does not load torch beside JAX.

PAD, M2 = 16, 6
_search = jax.jit(ref.affine_search_win, static_argnames=("s", "bit_depth"))
_dctif = jax.jit(ref._affine_dctif_pred, static_argnames=("s", "bit_depth"))


@pytest.mark.parametrize("shape", [(8, 8), (16, 32), (64, 16)],
                         ids=["8x8", "16x32", "64x16"])
def test_gpm_module_equal(shape):
    """The GPM masks, blends and candidate lists of the port's copy equal
    vvc's, and the modules that import the copy reach it."""
    import importlib
    from vvc.kernels import gpm as ref_gpm
    for mod in ("vvc_torch.kernels.mc", "vvc_torch.enc.mode_decide",
                "vvc_torch.cabac.cu_syntax"):
        importlib.import_module(mod)
    from vvc_torch.kernels import gpm
    w, h = shape
    rng = np.random.default_rng(w * h)
    p0 = rng.integers(0, 1024, (h, w)).astype(np.int32)
    p1 = rng.integers(0, 1024, (h, w)).astype(np.int32)
    for mode in range(64):
        m = gpm.gpm_mask(w, h, mode)
        np.testing.assert_array_equal(m, ref_gpm.gpm_mask(w, h, mode))
        np.testing.assert_array_equal(gpm.gpm_blend(p0, p1, m),
                                      ref_gpm.gpm_blend(p0, p1, m))
        np.testing.assert_array_equal(
            gpm.gpm_mask_chroma(w // 2, h // 2, mode),
            ref_gpm.gpm_mask_chroma(w // 2, h // 2, mode))
    cands = [(d, np.array([[1, -2], [3, 4]]) * d, (d % 2, d // 2))
             for d in (3, 1, 2, 3, 2, 1)]
    assert gpm.gpm_uni_candidates(cands) == ref_gpm.gpm_uni_candidates(cands)


def _case(s, bd, n, seed, content):
    """A padded reference, block origins, integer winners and seeds, the
    blocks, and vvc's w2 windows for them."""
    rng = np.random.default_rng(seed)
    H = W = 4 * s
    mx = (1 << bd) - 1
    if content == "flat":
        refpad = np.full((H + 2 * PAD, W + 2 * PAD), mx // 3, np.int32)
    elif content == "smooth":
        yy, xx = np.mgrid[0:H + 2 * PAD, 0:W + 2 * PAD]
        refpad = (mx * (0.5 + 0.45 * np.sin(xx / 7.0) * np.cos(yy / 5.0))
                  ).astype(np.int32)
    else:
        refpad = rng.integers(0, mx + 1, (H + 2 * PAD, W + 2 * PAD)).astype(
            np.int32)
    ys = rng.integers(0, H - s + 1, n).astype(np.int32)
    xs = rng.integers(0, W - s + 1, n).astype(np.int32)
    iy = np.clip(rng.integers(-4, 5, n), -(ys + PAD - M2),
                 H + PAD - s - 2 * M2 - ys + M2).astype(np.int32)
    ix = np.clip(rng.integers(-4, 5, n), -(xs + PAD - M2),
                 W + PAD - s - 2 * M2 - xs + M2).astype(np.int32)
    mvy0 = (4 * iy + rng.integers(-3, 4, n)).astype(np.int32)
    mvx0 = (4 * ix + rng.integers(-3, 4, n)).astype(np.int32)
    k = np.arange(s + 2 * M2)
    w2 = refpad[(ys + PAD + iy - M2)[:, None, None] + k[None, :, None],
                (xs + PAD + ix - M2)[:, None, None] + k[None, None, :]]
    if content == "noise":
        ob = rng.integers(0, mx + 1, (n, s, s)).astype(np.int32)
    else:
        ob = np.clip(w2[:, M2:M2 + s, M2:M2 + s]
                     + rng.integers(-3, 4, (n, s, s)), 0, mx).astype(np.int32)
    if content == "flat":
        ob = w2[:, M2:M2 + s, M2:M2 + s].copy()
    return refpad, ys, xs, iy, ix, mvy0, mvx0, ob, w2


def _both(case, lam, s, bd):
    import torch
    from vvc_torch.enc import me
    refpad, ys, xs, iy, ix, mvy0, mvx0, ob, w2 = case
    want = _search(*(jnp.asarray(a) for a in (w2, ob, mvy0, mvx0, iy, ix)),
                   jnp.float32(lam), s=s, bit_depth=bd)
    T = torch.from_numpy
    got = me.affine_search_plain(T(refpad), T(ob), T(ys), T(xs), T(mvy0),
                                 T(mvx0), T(iy), T(ix), np.float32(lam), s,
                                 bd)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().view(np.int32),
                                      np.asarray(w).view(np.int32))
    return [g.numpy() for g in got]


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("s", [16, 32, 64])
def test_affine_search_equal(s, bd):
    """Noise (many candidates move) and smooth content (ties of nearby
    candidates), λ of QP 27 and 37."""
    got = _both(_case(s, bd, 12, s + bd, "noise"), 3.1622777, s, bd)
    assert len(np.unique(got[1])) > 2 and len(np.unique(got[2])) > 2
    _both(_case(s, bd, 12, s + bd + 1, "smooth"), 7.943282, s, bd)


@pytest.mark.parametrize("qp", [21, 29])
def test_affine_search_costs_bit_equal(qp):
    """128 near-flat blocks (samples 100 or 101) at s = 16, where the
    costs are small and their last bit depends on the rounding: at QP 29's
    λ, 116 of the winners' costs differ if stage 1 contracted √λ·X into an
    FMA; at QP 21's, 18 differ if stage 2 rounded it apart (vvc does the
    opposite in each stage)."""
    from vvc_torch.enc.rdo import lambda_f32
    s, n = 16, 128
    rng = np.random.default_rng(s)
    refpad = (100 + rng.integers(0, 2, (4 * s + 2 * PAD, 4 * s + 2 * PAD))
              ).astype(np.int32)
    ys = rng.integers(0, 3 * s + 1, n).astype(np.int32)
    xs = rng.integers(0, 3 * s + 1, n).astype(np.int32)
    iy = ix = np.zeros(n, np.int32)
    mvy0 = rng.integers(-3, 4, n).astype(np.int32)
    mvx0 = rng.integers(-3, 4, n).astype(np.int32)
    ob = (100 + rng.integers(0, 2, (n, s, s))).astype(np.int32)
    k = np.arange(s + 2 * M2)
    w2 = refpad[(ys + PAD - M2)[:, None, None] + k[None, :, None],
                (xs + PAD - M2)[:, None, None] + k[None, None, :]]
    _both((refpad, ys, xs, iy, ix, mvy0, mvx0, ob, w2), lambda_f32(qp)[1],
          s, 8)


@pytest.mark.parametrize("s", [16, 64])
def test_affine_search_ties(s):
    """Flat content and λ = 0: every candidate costs the same.  Stage 1's
    first candidate (−8, −8) wins and no stage-2 step (equal cost) moves
    it."""
    got = _both(_case(s, 8, 4, 7, "flat"), 0.0, s, 8)
    assert (got[1] == -8).all() and (got[2] == -8).all()
    assert (got[0] == got[0][0]).all()


def test_affine_search_half_offsets():
    """A block that is exactly the bilinear prediction of (da, db) =
    (4, 0) at s = 16 (the winner, SATD 0): its DCTIF offsets q0 + dq fall
    on .5 at every subblock, where vvc's jnp.round goes half to even."""
    import torch
    from vvc_torch.enc import me
    s, bd = 16, 8
    refpad, ys, xs, iy, ix, mvy0, mvx0, _, w2 = _case(s, bd, 8, 3, "noise")
    mvy0, mvx0 = 4 * iy, 4 * ix                      # q0 = 0
    T = torch.from_numpy
    four = torch.full((8,), 4, dtype=torch.int64)
    ob = me._aff_bilinear(T(w2).long(), T(mvy0 - 4 * iy), T(mvx0 - 4 * ix),
                          four, four * 0, s, 255).numpy()
    got = _both((refpad, ys, xs, iy, ix, mvy0, mvx0, ob, w2), 3.1622777, s,
                bd)
    assert (got[1] == 4).all() and (got[2] == 0).all()
    numx, numy = me._aff_num(four, four * 0, s)
    assert ((numx % s) == s // 2).any() and ((numy % s) == s // 2).any()


@pytest.mark.parametrize("s", [16, 32, 64])
def test_affine_bilinear_positions_exact(s):
    """Every candidate position the search can reach (|da|, |db| ≤ 16:
    the grid's 8 plus 8 unit steps; |q0| ≤ 3) is a multiple of 1/128 in
    [1.5, 10.5] of the window: vvc's float32 passes are exact (10-bit
    samples: 10 + 7 bits after the row pass, + 7 after the column pass,
    below 2^24), and the clip at 2·M2 − 0.001 never binds."""
    cc = np.arange(s // 4) * 4 + 2 - s // 2
    d = np.arange(-16, 17)
    num = (d[:, None, None, None] * cc[None, None, :, None]
           + d[None, :, None, None] * cc[None, None, None, :])
    for q0 in range(-3, 4):
        pos = M2 + (q0 + num / s) / 4.0
        assert ((pos * 128) == np.round(pos * 128)).all()
        assert pos.min() >= 1.5 and pos.max() <= 10.5
    r = 1023 * 128                      # the row pass, scaled by 128
    assert r * 128 < 1 << 24 and r.bit_length() <= 17


@pytest.mark.parametrize("bd", [8, 10])
def test_affine_dctif_pred_equal(bd):
    """Every (qy, qx) in [−12, 11]² over 36 blocks of 16×16; at 10 bit
    some sums fall on 2048 (mod 4096), the ties of the rounding."""
    import torch
    from vvc_torch.enc import me
    from vvc_torch.kernels.mc import LUMA_FILTERS
    s, n = 16, 36
    refpad, ys, xs, iy, ix, _, _, _, w2 = _case(s, bd, n, 40 + bd, "noise")
    q = np.array([(a, b) for a in range(-12, 12) for b in range(-12, 12)])
    qy = q[:, 0].reshape(n, 4, 4).astype(np.int32)
    qx = q[:, 1].reshape(n, 4, 4).astype(np.int32)
    want = _dctif(jnp.asarray(w2, jnp.float32), jnp.asarray(qy),
                  jnp.asarray(qx), s=s, bit_depth=bd)
    T = torch.from_numpy
    got = me.affine_dctif_pred(T(refpad), T(ys), T(xs), T(iy), T(ix), T(qy),
                               T(qx), s, bd)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the exact sums: ties of the round half to even are present
    f = LUMA_FILTERS.astype(np.int64)
    qyy = np.repeat(np.repeat(qy, 4, 1), 4, 2)
    qxx = np.repeat(np.repeat(qx, 4, 1), 4, 2)
    k = np.arange(s)
    nn = np.arange(n)[:, None, None]
    acc = np.zeros((n, s, s), np.int64)
    for t in range(8):
        for u in range(8):
            acc += (f[qyy & 3, t] * f[qxx & 3, u]
                    * w2[nn, k[None, :, None] + (qyy >> 2) + 3 + t,
                         k[None, None, :] + (qxx >> 2) + 3 + u])
    assert ((acc % 4096) == 2048).sum() > (0 if bd == 8 else 2)


def _equal_and_decodes(want, got, recons, n):
    assert got == want
    dec, info = decode_stream(got)
    assert len(info["hash_ok"]) == n and all(info["hash_ok"])
    for r, d in zip(recons, dec):
        for a, b in ((r.y, d.y), (r.cb, d.cb), (r.cr, d.cr)):
            np.testing.assert_array_equal(a, b)


def _tool_totals(stats):
    tot = {}
    for st in stats:
        for k, v in st.get("inter_tools", {}).items():
            tot[k] = tot.get(k, 0) + v
    return tot


@pytest.mark.usefixtures("release_jax_programs")
def test_ldp_affine_stream_byte_equal_and_decodes():
    """LDP, 3 frames of the zoom clip at QP 32 with affine: affine leaves
    are chosen, the stream equals vvc's and decodes."""
    from vvc_torch.enc.encoder import encode_sequence as port_encode
    from vvc_torch.io.yuv import Frame as PortFrame
    frames = _warp_frames(3, zoom=0.035)
    want, _, _ = ref_encode(frames, qp=32, mode="ldp", affine=True)
    got, recons, stats = port_encode(
        [PortFrame(f.y.copy(), f.cb.copy(), f.cr.copy(), 8) for f in frames],
        qp=32, mode="ldp", affine=True, device="cpu")
    _equal_and_decodes(want, got, recons, 3)
    assert _tool_totals(stats)["affine"] > 0


TOOLS_4B = dict(affine=True, mctf=True, bdof=True, dmvr=True, mmvd=True,
                ciip=True, gpm=True, amvr=True, smvd=True, bcw=True)


@pytest.mark.slow
@pytest.mark.usefixtures("release_jax_programs")
def test_ra_all_4b_tools_stream_byte_equal_and_decodes():
    """Random Access GOP 4, 5 frames of the tool clip at 192×128, QP 32,
    with all ten slice-4b options: every tool chooses at least one leaf
    (BDOF/DMVR: bi leaves they refine; MCTF filters the two anchors), the
    stream equals vvc's and decodes."""
    from vvc_torch.enc.encoder import encode_sequence as port_encode
    from vvc_torch.io.yuv import Frame as PortFrame
    from vvc_torch.utils import perf
    w, h = 192, 128
    c = np.full((h // 2, w // 2), 128, np.int32)
    ys = tool_clip(5, w, h)
    want, _, _ = ref_encode([Frame(y, c, c, 8) for y in ys], qp=32,
                            mode="ra", gop_size=4, **TOOLS_4B)
    perf.reset()
    got, recons, stats = port_encode(
        [PortFrame(y.copy(), c.copy(), c.copy(), 8) for y in ys], qp=32,
        mode="ra", gop_size=4, device="cpu", **TOOLS_4B)
    _equal_and_decodes(want, got, recons, 5)
    tot = _tool_totals(stats)
    for k in ("affine", "mmvd", "ciip", "gpm", "bcw", "amvr", "smvd",
              "bdof_dmvr"):
        assert tot[k] > 0, (k, tot)
    assert perf.report()["mctf"]["n"] == 2

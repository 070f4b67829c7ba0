"""The r4 motion-search engine and the other device functions of slice 7
against vvc on the CPU, on the same numpy inputs:

  * `kernels.mc.interp_luma_planes` / `gather_pred_planes` ↔
    vvc/kernels/mc.py (exact; negative MVs and border clamps);
  * `kernels.satd.sse_batch` / `sad_batch` ↔ vvc/kernels/satd.py (SAD
    exact; SSE bit for bit, sums past 2^24 included);
  * `enc.inter_search.int_me` / `frac_refine` / `me_pred_program` ↔
    vvc/enc/inter_search.py `_int_me_dev`, `_frac_refine_dev` (each jitted
    as its one caller, `me_pred_program`, runs it) and `me_pred_program`:
    MVs, plane, err and cost bit for bit, at 8 and 10 bit, below and above
    vvc's chunk of 1024 blocks, and on a constructed cost tie;
  * `kernels.affine.affine_me_batch` ↔ vvc/kernels/affine.py: the corner
    MVs equal wherever 4·cp lies more than 1e-3 from a half-integer, within
    ±1 elsewhere (vvc's S²-term dots run in an XLA-CPU order the port does
    not reproduce);
  * `enc.me.eval_ref` ↔ vvc/enc/me.py `eval_ref` (jitted): every field.

Tolerance: exact, but for the affine corners (above)."""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vvc.enc import inter_search as ref_is
from vvc.enc import me as ref_me
from vvc.kernels import affine as ref_aff
from vvc.kernels import mc as ref_mc
from vvc.kernels import satd as ref_satd

from tests.test_affine import _plane
from tests.test_torch_rdo import _one_torch_thread  # noqa: F401

# torch and vvc_torch are imported inside the tests, so that a test worker
# that never runs them does not load torch beside JAX.

# the MCTF's λ_m of vvc's r4 engine at QP 32: √(0.57·2^((32−12)/3))
LAM_M = np.float32(np.sqrt(0.57 * 2 ** ((32 - 12) / 3)))

_int_me_jit = jax.jit(ref_is._int_me_dev, static_argnames=("size", "radius"))
_frac_jit = jax.jit(ref_is._frac_refine_dev, static_argnames=("size",))


def _t(a):
    import torch
    return torch.from_numpy(np.ascontiguousarray(a))


def _bits(a):
    return np.asarray(a).view(np.int32)


def _clip_frames(w, h, bd):
    from vvc_torch.io.synth import motion_clip
    fr = motion_clip(2, w, h, bit_depth=bd)
    return fr[1].y.astype(np.int32), fr[0].y.astype(np.int32)


def _raster(plane, s):
    h, w = plane.shape
    ny, nx = h // s, w // s
    blocks = (plane[:ny * s, :nx * s].reshape(ny, s, nx, s)
              .transpose(0, 2, 1, 3).reshape(-1, s, s))
    xs = (np.tile(np.arange(nx), ny) * s).astype(np.int32)
    ys = (np.repeat(np.arange(ny), nx) * s).astype(np.int32)
    return np.ascontiguousarray(blocks), xs, ys


# ---------------------------------------------------------------------------
# phase planes and the gather
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bd", [8, 10])
def test_interp_luma_planes_equal(bd):
    from vvc_torch.kernels import mc
    rng = np.random.default_rng(bd)
    plane = rng.integers(0, 1 << bd, (37, 53)).astype(np.int32)
    want = np.asarray(ref_mc.interp_luma_planes(plane, bd))
    got = mc.interp_luma_planes(_t(plane), bd).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got == (1 << bd) - 1).any() and (got == 0).any()   # clips


def test_gather_pred_planes_equal():
    """Negative MVs (arithmetic >> and & 3), MVs far outside the picture
    and blocks at every border, at S = 4, 8 and 16."""
    from vvc_torch.kernels import mc
    rng = np.random.default_rng(3)
    plane = rng.integers(0, 1024, (48, 64)).astype(np.int32)
    planes = ref_mc.interp_luma_planes(plane, 10)
    for s in (4, 8, 16):
        n = 300
        xs = rng.integers(0, 64 - s + 1, n).astype(np.int32)
        ys = rng.integers(0, 48 - s + 1, n).astype(np.int32)
        mvx = rng.integers(-400, 400, n).astype(np.int32)
        mvy = rng.integers(-300, 300, n).astype(np.int32)
        xs[:4], ys[:4] = (0, 64 - s, 0, 64 - s), (0, 0, 48 - s, 48 - s)
        mvx[:8] = (-1, -2, -3, -5, 1, 2, 3, 7)
        mvy[:8] = (-7, -1, 5, -2, -3, 6, 1, -4)
        want = np.asarray(ref_mc.gather_pred_planes(
            planes, jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(mvx),
            jnp.asarray(mvy), s))
        got = mc.gather_pred_planes(_t(np.asarray(planes)), _t(xs), _t(ys),
                                    _t(mvx), _t(mvy), s).numpy()
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# SSE and SAD
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s,bd,content", [(8, 8, "noise"), (16, 8, "noise"),
                                          (8, 10, "binary"),
                                          (16, 10, "binary"),
                                          (32, 10, "binary"),
                                          (64, 10, "noise")])
def test_sse_sad_batch_equal(s, bd, content):
    """SAD exact; SSE bit-equal to vvc's eager float32 sum.  At 8 bit (S ≤
    16) the sums are exact; the 10-bit cases pass 2^24 in most blocks,
    where the order decides (8×8 row lanes, 64×64 windows, else
    row-major), and a plain row-major order differs at 8 and 64."""
    import torch
    from vvc_torch.kernels import satd
    rng = np.random.default_rng(s + bd)
    mx = (1 << bd) - 1
    n = 257
    if content == "binary":
        a = (rng.integers(0, 2, (n, s, s)) * mx
             - rng.integers(0, 64, (n, s, s))).clip(0).astype(np.int32)
        b = (rng.integers(0, 2, (n, s, s)) * mx).astype(np.int32)
    else:
        a = rng.integers(0, mx + 1, (n, s, s)).astype(np.int32)
        b = rng.integers(0, mx + 1, (n, s, s)).astype(np.int32)
    want = np.asarray(ref_satd.sse_batch(jnp.asarray(a), jnp.asarray(b)))
    got = satd.sse_batch(_t(a), _t(b)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(
        satd.sad_batch(_t(a), _t(b)).numpy(),
        np.asarray(ref_satd.sad_batch(jnp.asarray(a), jnp.asarray(b))))
    d = (a.astype(np.int64) - b) ** 2
    big = d.sum(axis=(1, 2)) >= 1 << 24
    if bd == 10:
        assert big.mean() > 0.5
    if bd == 10 and s in (8, 64):
        seq = satd._seq_f32(torch.from_numpy(
            d.reshape(n, -1).astype(np.float32))).numpy()
        assert (_bits(seq) != _bits(want)).any()


# ---------------------------------------------------------------------------
# the r4 engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bd,wh", [(8, (96, 64)), (10, (96, 64)),
                                   (8, (512, 528)), (10, (512, 528))],
                         ids=["8bit", "10bit", "8bit-chunked",
                              "10bit-chunked"])
def test_r4_engine_equal(bd, wh):
    """`_int_me_dev` (from centre 0 and from random centres),
    `_frac_refine_dev` and `me_pred_program` at S = 16, R = 8 on
    motion_clip frames: MVs, cost, plane and err bit for bit.  528×512 has
    1056 blocks, past vvc's chunk of 1024 (its zero-padded lax.map)."""
    from vvc_torch.enc import inter_search as tis
    w, h = wh
    cur, refp = _clip_frames(w, h, bd)
    blocks, xs, ys = _raster(cur, 16)
    n = len(xs)
    assert (n > ref_is.CHUNK) == (h == 528)
    rng = np.random.default_rng(bd)
    for cx0, cy0 in ((np.zeros(n, np.int32), np.zeros(n, np.int32)),
                     (rng.integers(-6, 7, n).astype(np.int32),
                      rng.integers(-6, 7, n).astype(np.int32))):
        mx, my = _int_me_jit(jnp.asarray(blocks, jnp.float32),
                             jnp.asarray(refp, jnp.float32), jnp.asarray(xs),
                             jnp.asarray(ys), size=16, radius=8, lam_m=LAM_M,
                             cx0=jnp.asarray(cx0), cy0=jnp.asarray(cy0))
        gx, gy = tis.int_me(_t(blocks), _t(refp), _t(xs), _t(ys), 16, 8,
                            LAM_M, _t(cx0), _t(cy0))
        np.testing.assert_array_equal(gx.numpy(), np.asarray(mx))
        np.testing.assert_array_equal(gy.numpy(), np.asarray(my))
    planes = ref_mc.interp_luma_planes(refp, bd)
    tplanes = _t(np.asarray(planes))
    fx, fy, fc = _frac_jit(jnp.asarray(blocks), planes, jnp.asarray(xs),
                           jnp.asarray(ys), mx * 4, my * 4, size=16,
                           lam_m=LAM_M)
    ux, uy, uc = tis.frac_refine(_t(blocks), tplanes, _t(xs), _t(ys),
                                 _t(np.asarray(mx) * 4),
                                 _t(np.asarray(my) * 4), 16, LAM_M)
    np.testing.assert_array_equal(ux.numpy(), np.asarray(fx))
    np.testing.assert_array_equal(uy.numpy(), np.asarray(fy))
    np.testing.assert_array_equal(_bits(uc.numpy()), _bits(fc))
    assert (np.asarray(fx) % 4 != 0).any() and (np.asarray(fy) % 2 != 0).any()
    plane, err = ref_is.me_pred_program(jnp.asarray(cur), planes, 16, 8, w,
                                        h, LAM_M)
    tp, te = tis.me_pred_program(_t(cur), tplanes, 16, 8, w, h, LAM_M)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(plane))
    np.testing.assert_array_equal(_bits(te.numpy()), _bits(err))


def test_me_pred_program_err_above_2_24():
    """10-bit binary noise: most blocks' error sums pass 2^24, where vvc's
    float32 order (row-major from 0) decides err's bits."""
    from vvc_torch.enc import inter_search as tis
    rng = np.random.default_rng(7)
    h, w = 64, 96
    cur = (rng.integers(0, 2, (h, w)) * 1023).astype(np.int32)
    refp = (rng.integers(0, 2, (h, w)) * 1023).astype(np.int32)
    planes = ref_mc.interp_luma_planes(refp, 10)
    plane, err = ref_is.me_pred_program(jnp.asarray(cur), planes, 16, 8, w,
                                        h, LAM_M)
    tp, te = tis.me_pred_program(_t(cur), _t(np.asarray(planes)), 16, 8, w,
                                 h, LAM_M)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(plane))
    np.testing.assert_array_equal(_bits(te.numpy()), _bits(err))
    assert (np.asarray(err) * 256 >= 1 << 24).mean() > 0.5


def test_int_me_first_minimum_on_a_tie():
    """A reference of period 2 along x: the windows at x offsets −1 and +1
    are the same, each block matches them exactly, and |−4| = |4| gives
    the same MV bits: the costs tie and the first offset in raster order
    (−1) wins, in vvc and in the port."""
    from vvc_torch.enc import inter_search as tis
    rng = np.random.default_rng(11)
    h, w = 48, 64
    col = rng.integers(0, 256, (h, 2))
    refp = np.tile(col, (1, w // 2)).astype(np.int32)
    blocks = np.stack([refp[16:32, 15:31], refp[16:32, 33:49]]).astype(
        np.int32)
    xs = np.array([16, 32], np.int32)
    ys = np.array([16, 16], np.int32)
    z = np.zeros(2, np.int32)
    mx, my = _int_me_jit(jnp.asarray(blocks, jnp.float32),
                         jnp.asarray(refp, jnp.float32), jnp.asarray(xs),
                         jnp.asarray(ys), size=16, radius=8, lam_m=LAM_M,
                         cx0=jnp.asarray(z), cy0=jnp.asarray(z))
    gx, gy = tis.int_me(_t(blocks), _t(refp), _t(xs), _t(ys), 16, 8, LAM_M,
                        _t(z), _t(z))
    np.testing.assert_array_equal(np.asarray(mx), [-1, -1])
    np.testing.assert_array_equal(gx.numpy(), np.asarray(mx))
    np.testing.assert_array_equal(gy.numpy(), np.asarray(my))


# ---------------------------------------------------------------------------
# the Gauss-Newton affine ME
# ---------------------------------------------------------------------------


def _warp_pair(h, w, seed):
    """A smooth texture and its zoom about the centre by 3 %."""
    base = _plane(h, w, seed)
    yy, xx = np.mgrid[0:h, 0:w]
    sx = np.clip((xx - w / 2) / 1.03 + w / 2, 0, w - 1).astype(int)
    sy = np.clip((yy - h / 2) / 1.03 + h / 2, 0, h - 1).astype(int)
    return base[sy, sx].astype(np.int32), base


@pytest.mark.parametrize("n_params", [4, 6])
def test_affine_me_batch_within_tolerance(n_params):
    """CPMVs at S = 16, 32 and 64 from random quarter-pel seeds: equal to
    vvc's wherever 4·cp lies more than 1e-3 from a half-integer, within ±1
    elsewhere (the port's unrounded corners stand in for vvc's: the two
    differ by float32 noise)."""
    from vvc_torch.kernels import affine
    cur, base = _warp_pair(192, 256, 5)
    near = 0
    for s in (16, 32, 64):
        blocks, xs, ys = _raster(cur, s)
        rng = np.random.default_rng(s + n_params)
        m0x = rng.integers(-8, 9, len(xs)).astype(np.int32)
        m0y = rng.integers(-8, 9, len(xs)).astype(np.int32)
        bf, rf = blocks.astype(np.float32), base.astype(np.float32)
        want = ref_aff.affine_me_batch(bf, rf, xs, ys, m0x, m0y, s, 8,
                                       n_params=n_params)
        got = affine.affine_me_batch(_t(bf), _t(rf), _t(xs), _t(ys),
                                     _t(m0x), _t(m0y), s, 8,
                                     n_params=n_params).numpy()
        cp4 = affine.affine_me_corners(_t(bf), _t(rf), _t(xs), _t(ys),
                                       _t(m0x), _t(m0y), s,
                                       n_params).numpy().astype(np.float64)
        edge = np.abs(cp4 - np.floor(cp4) - 0.5) <= 1e-3
        near += int(edge.sum())
        np.testing.assert_array_equal(got[~edge], want[~edge])
        assert np.abs(got[edge].astype(np.int64) - want[edge]).max(
            initial=0) <= 1
        assert (want != np.stack([m0x, m0y], -1)[:, None]).any()
    print(f"affine {n_params}-parameter: {near} corner components within "
          f"1e-3 of a half-integer")


def test_affine_me_recovers_rotation():
    """vvc's tests/test_affine.py check, run on the port: the Gauss-Newton
    CPMVs of a small rotation predict well under the best translational
    fit."""
    from vvc_torch.kernels import affine
    from vvc_torch.kernels.mc import mc_block_np
    base = _plane(200, 200, 7)
    th = 0.03
    yy, xx = np.mgrid[0:64, 0:64].astype(np.float64)
    sx = np.cos(th) * (xx - 32) - np.sin(th) * (yy - 32) + 32 + 64
    sy = np.sin(th) * (xx - 32) + np.cos(th) * (yy - 32) + 32 + 64
    cur = base[np.clip(sy, 0, 199).astype(int),
               np.clip(sx, 0, 199).astype(int)].astype(np.float32)
    cp = affine.affine_me_batch(_t(cur[None]), _t(base.astype(np.float32)),
                                _t(np.array([64])), _t(np.array([64])),
                                _t(np.array([0])), _t(np.array([0])), 64,
                                8).numpy()
    pred = affine.affine_pred_batch_np(base, np.array([64]), np.array([64]),
                                       64, cp, 4, 8)[0]
    err_aff = np.abs(pred - cur).mean()
    best_tr = min(
        np.abs(mc_block_np(base, 64, 64, 64, 64, dx, dy, 8) - cur).mean()
        for dx in range(-8, 9, 2) for dy in range(-8, 9, 2))
    assert err_aff < 0.7 * best_tr, (err_aff, best_tr)


# ---------------------------------------------------------------------------
# eval_ref
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bd,s", [(8, 16), (10, 16), (8, 32), (10, 8)])
def test_eval_ref_equal(bd, s):
    """vvc's eval_ref (jitted, as its program would run it) from random
    coarse centres, some clipped at the borders: every field equal, the
    cost bit for bit."""
    from vvc_torch.enc import me
    h, w = 96, 128
    cur, refp = _clip_frames(w, h, bd)
    refpad, _ = ref_me._prep_ref(jnp.asarray(refp), h, w)
    ob, xs, ys = _raster(cur, s)
    rng = np.random.default_rng(bd + s)
    cy = rng.integers(-12, 13, len(xs)).astype(np.int32)
    cx = rng.integers(-40, 41, len(xs)).astype(np.int32)
    f = jax.jit(partial(ref_me.eval_ref, s=s, h=h, w=w, bit_depth=bd))
    want = f(refpad, jnp.asarray(ob), jnp.asarray(ys), jnp.asarray(xs),
             jnp.asarray(cy), jnp.asarray(cx), LAM_M)
    got = me.eval_ref(_t(np.asarray(refpad)), _t(ob), _t(ys), _t(xs), _t(cy),
                      _t(cx), LAM_M, s, h, w, bd)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(_bits(got[k].numpy()), _bits(want[k]),
                                      err_msg=k)

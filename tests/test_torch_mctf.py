"""Slice 4b's MCTF pre-filter against vvc's on the CPU:

  * `me.me_pred_v2` ↔ vvc/enc/me.py `me_pred_v2`: the prediction plane
    equal and the per-block mean squared error bit for bit, at 8 bit and
    at 10 bit on noise, where the block sums pass 2^24 and vvc's float32
    order decides (a sequential sum differs there);
  * `mctf.mctf_filter` ↔ vvc/enc/mctf.py `mctf_filter` on the content of
    vvc's tests/test_mctf.py (synthetic frames, a static scene with
    independent noise), filtered pictures equal.

Tolerance: exact."""
import jax.numpy as jnp
import numpy as np
import pytest

from vvc.enc import me as ref
from vvc.enc.mctf import mctf_filter as ref_mctf
from vvc.io.synth import synth_frame
from vvc.io.yuv import Frame

from tests.test_torch_rdo import _one_torch_thread  # noqa: F401

# torch and vvc_torch are imported inside the tests, so that a test worker
# that never runs them does not load torch beside JAX.


@pytest.mark.parametrize("bd", [8, 10])
def test_me_pred_v2_equal(bd):
    import torch
    from vvc_torch.enc import me
    h, w = 96, 136                    # 136: a partial block column
    rng = np.random.default_rng(bd)
    mx = (1 << bd) - 1
    refp = rng.integers(0, mx + 1, (h, w)).astype(np.int32)
    cur = np.clip(np.roll(refp, (2, -3), (0, 1))
                  + rng.integers(-9, 10, (h, w)), 0, mx).astype(np.int32)
    pp, ds = ref._prep_ref(jnp.asarray(refp), h, w)
    cds = ref._prep_ref(jnp.asarray(cur), h, w)[1]
    coarse = ref._coarse_program(cds, ds[None], (h + 3) // 4, (w + 3) // 4,
                                 ref.COARSE_R)
    lam = np.float32(3.7)
    plane, err = ref.me_pred_v2(jnp.asarray(cur), pp, coarse[16][0], w, h,
                                bd, jnp.float32(lam))
    T = torch.from_numpy
    tpp, tds = me.prep_ref(T(refp))
    tco = me.coarse_search(me.prep_ref(T(cur))[1], tds[None])
    got_plane, got_err = me.me_pred_v2(T(cur), tpp, tco[16][0], w, h, bd,
                                       lam)
    np.testing.assert_array_equal(got_plane.numpy(), np.asarray(plane))
    want = np.asarray(err)
    np.testing.assert_array_equal(got_err.numpy().view(np.int32),
                                  want.view(np.int32))
    if bd == 10:
        big = want * 256 >= 2 ** 24
        assert big.sum() > 10
        # a sequential float32 sum differs from vvc's order on these
        ny, nx = h // 16, w // 16
        d = (got_plane.numpy().astype(np.float32)
             - cur[:ny * 16, :nx * 16].astype(np.float32))
        sq = (d * d).reshape(ny, 16, nx, 16).transpose(0, 2, 1, 3).reshape(
            ny, nx, 256)
        seq = np.zeros((ny, nx), np.float32)
        for i in range(256):
            seq = (seq + sq[..., i]).astype(np.float32)
        assert ((seq * np.float32(1 / 256)) != want).any()


def _static_noise_frames():
    rng = np.random.default_rng(0)
    clean = rng.integers(40, 200, size=(64, 64)).astype(np.int32)
    out = []
    for _ in range(5):
        y = np.clip(clean + rng.integers(-8, 9, size=clean.shape), 0,
                    255).astype(np.int32)
        out.append((y, np.full((32, 32), 128, np.int32)))
    return out


@pytest.mark.parametrize("content,poc", [("synth", 2), ("synth", 0),
                                         ("static_noise", 2)])
def test_mctf_filter_equal(content, poc):
    from vvc_torch.enc.mctf import mctf_filter
    from vvc_torch.io.yuv import Frame as PortFrame
    if content == "synth":
        frames = [synth_frame(64, 64, t) for t in range(5)]
    else:
        frames = [Frame(y, c, c, 8) for y, c in _static_noise_frames()]
    want = ref_mctf(frames, poc, qp=32)
    got = mctf_filter([PortFrame(f.y.copy(), f.cb.copy(), f.cr.copy(), 8)
                       for f in frames], poc, qp=32, device="cpu")
    np.testing.assert_array_equal(got.y, want.y)
    np.testing.assert_array_equal(got.cb, want.cb)
    assert not np.array_equal(got.y, frames[poc].y)     # it filtered

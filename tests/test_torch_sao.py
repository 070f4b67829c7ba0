"""The port's SAO encoder (vvc_torch.kernels.sao sao_stats_dev,
vvc_torch.enc.sao_enc decide_sao_frame) against vvc's on the CPU: the
per-CTU statistics of one component against vvc's jitted sao_stats_dev
(8, 10 and 12 bit, CTU sizes 64 and 32, planes that are not CTU
multiples, one tile and 2 tile columns, a CTU whose sums come near 2^24),
and the per-CTU SAO parameters of whole pictures.  Tolerance: exact —
every statistic is an integer below 2^24, so vvc's float32 block sums
are exact in any order and equal the port's."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from vvc.enc import sao_enc as ref_enc
from vvc.enc.encoder import tile_columns, tile_grid
from vvc.kernels import sao as ref

from tests.test_torch_rdo import _one_torch_thread  # noqa: F401

# torch and vvc_torch are imported inside the tests, so that a test worker
# that never runs them does not load torch beside JAX.


def _stats_both(orig, rec, vx, vy, cs, bit_depth):
    import torch
    from vvc_torch.kernels import sao as port
    want = ref.sao_stats_dev(jnp.asarray(orig), jnp.asarray(rec),
                             jnp.asarray(vx), jnp.asarray(vy), cs, bit_depth)
    got = port.sao_stats_dev(torch.from_numpy(orig), torch.from_numpy(rec),
                             torch.from_numpy(vx), torch.from_numpy(vy), cs,
                             bit_depth)
    return [g.numpy() for g in got], [np.asarray(x) for x in want]


@pytest.mark.parametrize("bit_depth,cs,h,w,cols", [
    (8, 64, 240, 416, 1), (10, 32, 136, 200, 2), (8, 64, 136, 200, 2),
    (10, 64, 120, 208, 1)], ids=["8bit-cs64-tile", "10bit-cs32-2cols",
                                 "8bit-cs64-2cols-partial",
                                 "10bit-cs64-partial"])
def test_sao_stats_equal(bit_depth, cs, h, w, cols):
    rng = np.random.default_rng(bit_depth * cs + h)
    mx = (1 << bit_depth) - 1
    orig = rng.integers(0, mx + 1, (h, w)).astype(np.int32)
    rec = np.clip(orig + rng.integers(-9, 10, (h, w)), 0, mx).astype(np.int32)
    rec[:8] = rec[:8, :1]                    # flat rows: EO category 0 too
    tiles = [(x0, x1, 0, h) for x0, x1 in tile_columns(cols, w, cs)]
    vx, vy = ref_enc._valid_vectors(h, w, tiles)
    got, want = _stats_both(orig, rec, vx, vy, cs, bit_depth)
    for g, wv in zip(got, want):
        assert g.dtype == np.float32 and g.shape == wv.shape
        np.testing.assert_array_equal(g, wv)
    # every EO class and band sees samples
    assert (got[1].sum(axis=(2, 3)) > 0).all() and got[3].sum() == h * w


def test_sao_stats_near_2_24():
    """12-bit-sized differences over a full 64×64 CTU: the band-0 sum is
    4096·4094 or more, just below 2^24, where a float32 sum is still
    exact; the port's equals vvc's and the exact integer."""
    rng = np.random.default_rng(0)
    h = w = 128
    orig = np.full((h, w), 4095, np.int32)
    rec = rng.integers(0, 2, (h, w)).astype(np.int32)
    rec[64:, 64:] = rng.integers(0, 4096, (64, 64))
    vx, vy = ref_enc._valid_vectors(h, w, [(0, w, 0, h)])
    got, want = _stats_both(orig, rec, vx, vy, 64, 12)
    for g, wv in zip(got, want):
        np.testing.assert_array_equal(g, wv)
    exact = (orig[:64, :64] - rec[:64, :64]).astype(np.int64).sum()
    assert got[2][0, 0, 0] == exact and exact >= 4096 * 4094
    assert got[0][:, :, 0, 0].any()          # EO sums of the same CTU


def _pictures(bit_depth, rng, amps, w=416, h=240):
    mx = (1 << bit_depth) - 1
    for amp in amps:
        orig = [rng.integers(0, mx + 1, s).astype(np.int32)
                for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2))]
        # textured content plus noise (EO wins), and a left third whose
        # samples span 4 bands and whose recon is biased (BO wins)
        band = 1 << (bit_depth - 5)
        for p in orig:
            p[:] = np.cumsum(np.cumsum(p % 3, 0), 1) % (mx + 1)
            p[:, :p.shape[1] // 3] = mx // 2 + p[:, :p.shape[1] // 3] % (
                4 * band)
        rec = [np.clip(p + rng.integers(-amp, amp + 1, p.shape)
                       + (amp // 2), 0, mx).astype(np.int32) for p in orig]
        yield orig, rec


def _fields(params):
    """{ctu: (y, cb, cr)} → plain tuples (the two packages' SaoParams are
    distinct classes)."""
    return {k: tuple(dataclasses.astuple(p) for p in ps)
            for k, ps in params.items()}


@pytest.mark.parametrize("bit_depth", (8, 10))
@pytest.mark.parametrize("cols", (1, 2))
def test_decide_sao_frame_equal(bit_depth, cols):
    """Equal SaoParams for every CTU and component of 416×240 pictures,
    recon = orig + seeded noise at 3 amplitudes."""
    from vvc_torch.enc import sao_enc as port_enc
    rng = np.random.default_rng(bit_depth + cols)
    w, h = 416, 240
    tiles = tile_grid(cols, 1, w, h, 64)
    modes = set()
    for orig, rec in _pictures(bit_depth, rng, (2, 5, 12 << (bit_depth - 8))):
        want = ref_enc.decide_sao_frame(orig, rec, 32, bit_depth, 64, tiles)
        got = port_enc.decide_sao_frame(orig, rec, 32, bit_depth, 64, tiles,
                                        device="cpu")
        assert _fields(got) == _fields(want)
        modes |= {p.mode for ps in got.values() for p in ps}
    assert modes >= {ref.SAO_BO, ref.SAO_EO}

"""The port's device CCLM functions (vvc_torch.kernels.cclm
luma_ds_plane_dev, derive_models_batch_dev) against vvc's jitted
luma_ds_plane_jnp and derive_models_batch_jnp on the CPU: frame and tile
planes, frame-edge blocks, blocks with no neighbour, tied luma values
(the stable sort), negative slopes whose division is not exact (floor,
not truncation) and den = 0.  Tolerance: exact (int32 semantics)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vvc.kernels import cclm as ref

from tests.test_torch_rdo import _one_torch_thread  # noqa: F401

# torch and vvc_torch are imported inside the tests, so that a test worker
# that never runs them does not load torch beside JAX.


@pytest.mark.parametrize("bit_depth", (8, 10))
@pytest.mark.parametrize("h,w", [(64, 128), (64, 64), (1080, 1920)],
                         ids=["frame", "tile", "hd"])
def test_luma_ds_plane_equal(h, w, bit_depth):
    import torch
    from vvc_torch.kernels import cclm as port
    rng = np.random.default_rng(h + w + bit_depth)
    luma = rng.integers(0, 1 << bit_depth, (h, w)).astype(np.int32)
    luma[:, 0] = (1 << bit_depth) - 1      # the clamped left column shows
    want = np.asarray(jax.jit(ref.luma_ds_plane_jnp)(jnp.asarray(luma)))
    got = port.luma_ds_plane_dev(torch.from_numpy(luma))
    assert got.dtype == torch.int32 and got.shape == (h // 2, w // 2)
    np.testing.assert_array_equal(got.numpy(), want)


def _models_ref(ds, chroma, xs, ys, cs, bit_depth, variant):
    fn = jax.jit(ref.derive_models_batch_jnp,
                 static_argnames=("cs", "bit_depth", "variant"))
    a, b = fn(jnp.asarray(ds), jnp.asarray(chroma), jnp.asarray(xs),
              jnp.asarray(ys), cs=cs, bit_depth=bit_depth, variant=variant)
    return np.asarray(a), np.asarray(b)


def _models_port(ds, chroma, xs, ys, cs, bit_depth, variant):
    import torch
    from vvc_torch.kernels import cclm as port
    a, b = port.derive_models_batch_dev(
        torch.from_numpy(ds), torch.from_numpy(chroma), torch.from_numpy(xs),
        torch.from_numpy(ys), cs, bit_depth, variant)
    assert a.dtype == torch.int32 and b.dtype == torch.int32
    return a.numpy(), b.numpy()


@pytest.mark.parametrize("variant", (1, 2, 3))
@pytest.mark.parametrize("cs,bit_depth", [(4, 8), (8, 10), (16, 8),
                                          (32, 10)])
def test_derive_models_batch_equal(cs, bit_depth, variant):
    rng = np.random.default_rng(cs * 7 + variant + bit_depth)
    ch, cw = 64, 96
    mx = (1 << bit_depth) - 1
    ds = rng.integers(0, mx + 1, (ch, cw)).astype(np.int32)
    chroma = rng.integers(0, mx + 1, (ch, cw)).astype(np.int32)
    ds[0:8] = rng.integers(0, 4, (8, cw))     # coarse luma: many ties
    ys_, xs_ = np.mgrid[0:ch - cs + 1:cs, 0:cw - cs + 1:cs]
    xs = np.concatenate([xs_.ravel(), rng.integers(0, cw, 40)])
    ys = np.concatenate([ys_.ravel(), rng.integers(0, ch, 40)])
    xs = xs.astype(np.int32)
    ys = ys.astype(np.int32)
    want = _models_ref(ds, chroma, xs, ys, cs, bit_depth, variant)
    got = _models_port(ds, chroma, xs, ys, cs, bit_depth, variant)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    # the (0, 0) block has no neighbour: the mid-grey fallback
    assert got[0][0] == 0 and got[1][0] == 1 << (bit_depth - 1)


def test_derive_models_constructed_cases():
    """One block per case (`_one_block`), variant 1."""
    cases = []
    # (a) tied luma: the stable order decides which chroma pairs form min
    #     and max — 3 equal luma values
    cases.append(([50, 50, 50, 90], [10, 200, 30, 40]))
    # (b) negative slope, inexact division: floor, not truncation
    cases.append(([20, 30, 200, 210], [180, 170, 41, 40]))
    # (c) den = 0: all luma equal → α = 0, β = cmin
    cases.append(([77, 77, 77, 77], [5, 9, 250, 3]))
    # (d) negative slope with a large lmin: the arithmetic shift of α·lmin
    cases.append(([240, 241, 250, 255], [200, 190, 3, 1]))
    for lum, chv in cases:
        args = _one_block(lum, chv)
        want = _models_ref(*args)
        got = _models_port(*args)
        assert (int(got[0][0]), int(got[1][0])) == (int(want[0][0]),
                                                    int(want[1][0]))
    # (b) divides inexactly with a negative numerator, where floor and
    #     truncation differ: the port floors
    num, den = ((41 + 40 + 1) // 2 - (180 + 170 + 1) // 2) << 13, 180
    assert num < 0 and num // den != int(np.trunc(num / den))
    got = _models_port(*_one_block(*cases[1]))
    assert int(got[0][0]) == num // den


def _one_block(lum, chv):
    """Planes with the 4 neighbour points of the block at (8, 8), cs = 8,
    variant 1: top row 7 at x = 10, 14, left column 7 at y = 10, 14."""
    ds = np.full((24, 24), 128, np.int32)
    chroma = np.full((24, 24), 128, np.int32)
    for (py, px), l, c in zip([(7, 10), (7, 14), (10, 7), (14, 7)], lum, chv):
        ds[py, px] = l
        chroma[py, px] = c
    return (ds, chroma, np.array([8], np.int32), np.array([8], np.int32), 8,
            8, 1)

"""Port of the 67-mode intra prediction and the RDO reference lines
(vvc_torch.kernels.intra, vvc_torch.enc.rdo) against vvc's numpy oracles.

Tolerance: exact equality (integer semantics)."""
import numpy as np
import pytest

from vvc.kernels import intra as ref_intra

from tests.test_torch_rdo import _one_torch_thread  # noqa: F401

# torch and vvc_torch are imported inside the tests, so that a test worker
# that never runs them does not load torch beside JAX.


SIZES = (4, 8, 16, 32, 64)


@pytest.mark.parametrize("bit_depth", (8, 10))
@pytest.mark.parametrize("size", SIZES)
def test_predict_all_modes_batch_matches_numpy_oracle(size, bit_depth):
    import torch
    from vvc_torch.kernels import intra as port_intra
    rng = np.random.default_rng(100 + size + bit_depth)
    refs = rng.integers(0, 1 << bit_depth, size=(6, 4 * size + 3)
                        ).astype(np.int32)
    refs[0] = refs[0, 0]               # flat line: ties across modes
    want = ref_intra.predict_all_modes_batch_np(refs, size, bit_depth)
    got = port_intra.predict_all_modes_batch(torch.from_numpy(refs), size,
                                             bit_depth)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bit_depth", (8, 10))
@pytest.mark.parametrize("size", SIZES)
def test_build_ref_lines_device_matches_numpy_oracle(size, bit_depth):
    import torch
    from vvc_torch.enc import rdo as port_rdo
    rng = np.random.default_rng(200 + size + bit_depth)
    h, w = 72, 136
    plane = rng.integers(0, 1 << bit_depth, size=(h, w)).astype(np.int32)
    xs = rng.integers(0, w, size=24).astype(np.int32)
    ys = rng.integers(0, h, size=24).astype(np.int32)
    xs[:4] = 0                          # frame edges: every substitution
    ys[2:6] = 0
    xs[-1], ys[-1] = w - size, h - size
    want = ref_intra.build_ref_lines_orig_np(plane, xs, ys, size, bit_depth)
    got = port_rdo.build_ref_lines_device(torch.from_numpy(plane),
                                          torch.from_numpy(xs),
                                          torch.from_numpy(ys), size,
                                          bit_depth)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bit_depth", (8, 10))
@pytest.mark.parametrize("size", (4, 8, 16, 32))
def test_predict_modes_batch_equal(size, bit_depth):
    """One mode per block (the chroma DM prediction) against vvc's jitted
    predict_modes_batch: every mode 0..66 on random and flat lines, and
    modes outside 0..66, which vvc clamps onto the edge table rows."""
    import jax
    import jax.numpy as jnp
    import torch
    from vvc_torch.kernels import intra as port_intra
    rng = np.random.default_rng(300 + size + bit_depth)
    modes = np.concatenate([np.arange(67), np.arange(67), [-3, 67, 75]])
    modes = modes.astype(np.int32)
    refs = rng.integers(0, 1 << bit_depth, size=(len(modes), 4 * size + 3)
                        ).astype(np.int32)
    refs[67:80] = refs[67:80, :1]      # flat lines
    fn = jax.jit(ref_intra.predict_modes_batch,
                 static_argnames=("size", "bit_depth"))
    want = np.asarray(fn(jnp.asarray(refs), jnp.asarray(modes), size=size,
                         bit_depth=bit_depth))
    got = port_intra.predict_modes_batch(torch.from_numpy(refs),
                                         torch.from_numpy(modes), size,
                                         bit_depth)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the one-mode prediction is the mode's plane of the 67-mode prediction
    full = ref_intra.predict_all_modes_batch_np(refs[:67], size, bit_depth)
    np.testing.assert_array_equal(got.numpy()[:67],
                                  full[np.arange(67), np.arange(67)])

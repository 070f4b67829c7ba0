"""The port's all-modes MIP predictor (vvc_torch.kernels.mip) against
vvc's (vvc/kernels/mip.py:112 mip_predict_all_batch) on the CPU, for
S = 8, 16, 32 and bit depths 8 and 10, on random reference lines and on
flat ones.  Tolerance: exact (integer outputs)."""
import jax.numpy as jnp
import numpy as np
import pytest

from vvc.kernels import mip as ref

from tests.test_torch_rdo import _one_torch_thread  # noqa: F401

# torch and vvc_torch are imported inside the tests, so that a test worker
# that never runs them does not load torch beside JAX.


@pytest.mark.parametrize("bit_depth", (8, 10))
@pytest.mark.parametrize("size", (8, 16, 32))
def test_mip_predict_all_equal(size, bit_depth):
    import torch
    from vvc_torch.kernels import mip as port
    rng = np.random.default_rng(size * bit_depth)
    refs = rng.integers(0, 1 << bit_depth, (40, 4 * size + 3)).astype(
        np.int32)
    refs[:4] = rng.integers(0, 1 << bit_depth, (4, 1))      # flat lines
    refs[4:8, :2 * size] = 0                                  # dark left
    refs[4:8, 2 * size:] = (1 << bit_depth) - 1               # bright top
    want = np.asarray(ref.mip_predict_all_batch(jnp.asarray(refs), size,
                                                bit_depth))
    got = port.mip_predict_all_batch(torch.from_numpy(refs), size,
                                     bit_depth)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)

"""The port's batched transforms (vvc_torch.kernels.transform) against
vvc's (vvc/kernels/transform.py:78 fwd_transform_batch, :94
inv_transform_batch) on the CPU: every MTS pair at 8..32 points, DCT2 at
64, bit depths 8 and 10.  Tolerance: exact (integer outputs)."""
import jax.numpy as jnp
import numpy as np
import pytest

from vvc.kernels import transform as ref

from tests.test_torch_rdo import _one_torch_thread  # noqa: F401

# torch and vvc_torch are imported inside the tests, so that a test worker
# that never runs them does not load torch beside JAX.


CASES = [(mts, s, bd) for bd in (8, 10) for s in (8, 16, 32, 64)
         for mts in range(len(ref.MTS_TR)) if s < 64 or mts == 0]


@pytest.mark.parametrize("mts,size,bit_depth", CASES,
                         ids=[f"mts{m}-{s}x{s}-{b}bit" for m, s, b in CASES])
def test_fwd_inv_transform_equal(mts, size, bit_depth):
    import torch
    from vvc_torch.kernels import transform as port
    th, tv = ref.MTS_TR[mts]
    rng = np.random.default_rng(100 * size + 10 * mts + bit_depth)
    lim = 1 << bit_depth
    resi = rng.integers(-lim + 1, lim, (24, size, size)).astype(np.int32)
    # coefficients over the whole 16-bit range exercise both clamps
    coeff = rng.integers(-32768, 32768, (24, size, size)).astype(np.int32)
    coeff[:8] >>= 6
    want_f = np.asarray(ref.fwd_transform_batch(jnp.asarray(resi), bit_depth,
                                                th, tv))
    got_f = port.fwd_transform_batch(torch.from_numpy(resi), bit_depth,
                                     th, tv)
    assert got_f.dtype == torch.int32
    np.testing.assert_array_equal(got_f.numpy(), want_f)
    want_i = np.asarray(ref.inv_transform_batch(jnp.asarray(coeff),
                                                bit_depth, th, tv))
    got_i = port.inv_transform_batch(torch.from_numpy(coeff), bit_depth,
                                     th, tv)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    # the round trip on the forward output, as the RDO runs it
    np.testing.assert_array_equal(
        port.inv_transform_batch(got_f, bit_depth, th, tv).numpy(),
        np.asarray(ref.inv_transform_batch(jnp.asarray(want_f), bit_depth,
                                           th, tv)))

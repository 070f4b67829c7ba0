"""Port of the Hadamard SATD (vvc_torch.kernels.satd) against the JAX
satd_batch, run on the CPU backend.  Tolerance: exact (int32)."""
import jax.numpy as jnp
import numpy as np
import pytest

from vvc.kernels.satd import hadamard as ref_hadamard
from vvc.kernels.satd import satd_batch as ref_satd

from tests.test_torch_rdo import _one_torch_thread  # noqa: F401

# torch and vvc_torch are imported inside the tests, so that a test worker
# that never runs them does not load torch beside JAX.


@pytest.mark.parametrize("h,w", [(4, 4), (4, 8), (8, 4), (8, 8), (16, 8),
                                 (8, 16), (16, 16), (32, 32), (64, 64)])
def test_satd_batch_matches_jax(h, w):
    import torch
    from vvc_torch.kernels import satd as port
    rng = np.random.default_rng(h * 100 + w)
    a = rng.integers(0, 1024, size=(7, h, w)).astype(np.int32)
    b = rng.integers(0, 1024, size=(7, h, w)).astype(np.int32)
    want = np.asarray(ref_satd(jnp.asarray(a), jnp.asarray(b)))
    got = port.satd_batch(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32 and got.shape == (7,)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("s", [4, 8, 32])
def test_satd_broadcast_form_matches_jax(s):
    """[N,M,S,S] predictions against [N,S,S] originals → [N,M]: the form
    the search uses, equal to JAX on the explicit broadcast copy."""
    import torch
    from vvc_torch.kernels import satd as port
    rng = np.random.default_rng(s)
    n, m = 3, 67
    preds = rng.integers(0, 256, size=(n, m, s, s)).astype(np.int32)
    orig = rng.integers(0, 256, size=(n, s, s)).astype(np.int32)
    want = np.asarray(ref_satd(
        jnp.asarray(preds.reshape(-1, s, s)),
        jnp.asarray(np.broadcast_to(orig[:, None], preds.shape
                                    ).reshape(-1, s, s)))).reshape(n, m)
    got = port.satd_batch(torch.from_numpy(preds), torch.from_numpy(orig))
    assert got.shape == (n, m)
    np.testing.assert_array_equal(got.numpy(), want)


def test_hadamard_rows_match_reference():
    from vvc_torch.kernels import satd as port
    for n in (1, 2, 4, 8):
        np.testing.assert_array_equal(port.hadamard(n), ref_hadamard(n))

"""The port's batched LFNST (vvc_torch.kernels.lfnst fwd/inv_lfnst_batch,
the RD search's stage C) against vvc's jitted fwd/inv_lfnst_batch on the
CPU.  Tolerance: exact (int32 semantics)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vvc.kernels import lfnst as ref
from vvc.rom.lfnst_mats import lfnst_kernels

from tests.test_torch_rdo import _one_torch_thread  # noqa: F401

# torch and vvc_torch are imported inside the tests, so that a test worker
# that never runs them does not load torch beside JAX.


# modes of every set, both sides of the transpose at 34/35, and MIP
MODES = np.array([0, 1, 2, 12, 13, 23, 24, 34, 35, 45, 46, 56, 57, 66, 67,
                  71, 75], dtype=np.int32)


@pytest.fixture(scope="module")
def ref_fns():
    return (jax.jit(ref.fwd_lfnst_batch, static_argnames="lfnst_idx"),
            jax.jit(ref.inv_lfnst_batch, static_argnames="lfnst_idx"))


@pytest.mark.parametrize("li", (1, 2))
@pytest.mark.parametrize("size", (8, 16, 32, 64))
def test_fwd_inv_lfnst_batch_equal(ref_fns, size, li):
    import torch
    from vvc_torch.kernels import lfnst as port
    rng = np.random.default_rng(size * 10 + li)
    n = 3 * len(MODES)
    coeff = rng.integers(-32768, 32768, (n, size, size)).astype(np.int32)
    coeff[len(MODES):2 * len(MODES)] //= 64       # inside the clip too
    coeff[-4:] = np.where(coeff[-4:] >= 0, 32767, -32768)   # the extremes
    modes = np.tile(MODES, 3)
    fwd, inv = ref_fns
    for ref_fn, port_fn in ((fwd, port.fwd_lfnst_batch),
                            (inv, port.inv_lfnst_batch)):
        want = np.asarray(ref_fn(jnp.asarray(coeff), jnp.asarray(modes),
                                 lfnst_idx=li))
        got = port_fn(torch.from_numpy(coeff), torch.from_numpy(modes), li)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    # the 16-bit clip is reached
    y = port.fwd_lfnst_batch(torch.from_numpy(coeff), torch.from_numpy(modes),
                             li)
    assert int(y.abs().max()) >= 32767


def test_sets_batch_equal():
    import torch
    from vvc_torch.kernels import lfnst as port
    modes = np.arange(-2, 80, dtype=np.int32)
    g_want, t_want = jax.jit(ref._sets_batch)(jnp.asarray(modes))
    g, t = port._sets_batch(torch.from_numpy(modes))
    np.testing.assert_array_equal(g.numpy(), np.asarray(g_want))
    np.testing.assert_array_equal(t.numpy(), np.asarray(t_want))


def test_int8_kernel_table_is_exact():
    """The CUDA kernel reads the [4,2,16,64] table as int8: the cast loses
    nothing, and the copy is vvc's table."""
    from vvc_torch.kernels import lfnst as port
    want = lfnst_kernels()
    k8 = port._kernels_dev("cpu").numpy()
    assert k8.dtype == np.int8 and k8.shape == (4, 2, 16, 64)
    np.testing.assert_array_equal(k8.astype(want.dtype), want)

"""Port of the lossless intra RDO search (vvc_torch.enc.rdo) against
vvc.enc.rdo on the CPU backend.  Tolerance: bit-exact — the packed search
vector carries float32 costs that the host DP compares bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vvc.enc import rdo as ref
from vvc.io.synth import synth_frame

# torch and vvc_torch are imported inside the tests, so that a test worker
# that never runs them does not load torch beside JAX.

W, H = 128, 64
SHAPES = ref._candidate_shapes(64, 8, False)


@pytest.fixture(scope="module")
def frame():
    return synth_frame(W, H, 1)


@pytest.fixture(scope="module")
def port():
    from vvc_torch.enc import rdo
    return rdo


@pytest.mark.parametrize("qp", (22, 37))
def test_packed_search_vector_bit_equal(frame, port, qp):
    import torch
    vec = ref.pack_planes(frame.y)
    want = np.asarray(ref.eval_all_sizes(jnp.asarray(vec), SHAPES,
                                         jnp.int32(qp), 8, W, H, True, False,
                                         False, False))
    got = port.eval_all_sizes(torch.from_numpy(vec), SHAPES, qp, 8, W, H,
                              True, False, False, False).numpy()
    assert got.dtype == np.int32
    # vvc also packs the TT middle-child planes, which the QT-only DP never
    # reads; the square-shape part (a prefix) must be bit-equal
    tail = sum(6 * (H // 32) * (W // 32) for _ in ref._tt_descriptors(SHAPES))
    assert len(want) == len(got) + tail
    np.testing.assert_array_equal(got, want[:len(got)])


def test_rdo_partition_leaves_equal(frame, port):
    _, _, want = ref.rdo_partition(frame.y, 32, 8, lossless=True,
                                   lfnst=False)
    _, _, got = port.rdo_partition(frame.y, 32, 8, lossless=True,
                                   lfnst=False, device="cpu")
    key = lambda l: (l.x0, l.y0, l.w, l.h, l.luma_mode, l.mts, l.lfnst,
                     l.isp, l.chroma_mode)
    assert [key(l) for l in got] == [key(l) for l in want]


def test_lambda_tables_match_jax_bits(port):
    @jax.jit
    def lam_fn(qp):
        lam = 0.57 * jnp.exp2((qp.astype(jnp.float32) - 12.0) / 3.0)
        return lam, jnp.sqrt(lam)

    lam, sqrt_lam = lam_fn(jnp.arange(64, dtype=jnp.int32))
    np.testing.assert_array_equal(
        np.asarray(lam).view(np.uint32),
        np.asarray(port.LAMBDA_F32_BITS, dtype=np.uint32))
    np.testing.assert_array_equal(
        np.asarray(sqrt_lam).view(np.uint32),
        np.asarray(port.SQRT_LAMBDA_F32_BITS, dtype=np.uint32))
    assert port.lambda_f32(37)[1] == np.asarray(sqrt_lam)[37]


def test_argmin_tie_takes_first_like_jnp(port):
    import torch
    cost = np.array([[3.0, 1.0, 1.0, 2.0],
                     [0.5, 0.5, 0.5, 0.5],
                     [4.0, 4.0, 2.0, 2.0]], dtype=np.float32)
    best_cost, best_mode = port._min_argmin(torch.from_numpy(cost))
    np.testing.assert_array_equal(best_mode.numpy(),
                                  np.asarray(jnp.argmin(cost, axis=1)))
    np.testing.assert_array_equal(best_cost.numpy(),
                                  np.asarray(jnp.min(cost, axis=1)))
    assert best_mode.dtype == torch.int32


def test_lossy_and_mtt_raise_not_implemented(frame, port):
    with pytest.raises(NotImplementedError, match="slice 2"):
        port.rdo_partition(frame.y, 32, 8, lossless=False, device="cpu")
    with pytest.raises(NotImplementedError, match="slice 2"):
        port.rdo_partition(frame.y, 32, 8, lossless=True, mtt=True,
                           device="cpu")

"""The port's quantiser, dequantiser and level-rate model against vvc's on
the CPU: quant_batch / dequant_batch (vvc/kernels/quant.py:87,106) at
every QP 0..63 over the whole 16-bit coefficient range (levels up to
32767), level_bits_jnp (vvc/cabac/rates.py:41) for every |level| 0..32767,
and the fused quant_rate pass that the RDO runs.  Tolerance: exact, bit
for bit, except the per-block rate sum, whose order is XLA's inside the
fused RDO program (tests/test_torch_rdo.py holds that bit-equal); here it
is held to a float64 sum within S²·2^-24 relative, the worst-case error of
a float32 sum of S² positive terms."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vvc.cabac import rates as ref_rates
from vvc.kernels import quant as ref

from tests.test_torch_rdo import _one_torch_thread  # noqa: F401

# torch and vvc_torch are imported inside the tests, so that a test worker
# that never runs them does not load torch beside JAX.


def _coeffs(size: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    c = rng.integers(-32768, 32768, (12, size, size)).astype(np.int32)
    c[:4] >>= 8                                   # typical magnitudes
    c[4:6] >>= 3
    c[6, 0, :4] = (-32768, 32767, 0, -1)          # extremes
    return c


@pytest.mark.parametrize("bit_depth", (8, 10))
@pytest.mark.parametrize("size", (8, 16, 32, 64))
def test_quant_dequant_equal_all_qps(size, bit_depth):
    import torch
    from vvc_torch.kernels import quant as port
    coeff = _coeffs(size, size + bit_depth)
    qbatch = jax.jit(ref.quant_batch, static_argnames=("bit_depth",))
    dqbatch = jax.jit(ref.dequant_batch, static_argnames=("bit_depth",))
    for qp in range(64):
        want = np.asarray(qbatch(jnp.asarray(coeff), jnp.int32(qp),
                                 bit_depth=bit_depth))
        got = port.quant_batch(torch.from_numpy(coeff), qp, bit_depth)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"qp {qp}")
        want_d = np.asarray(dqbatch(jnp.asarray(want), jnp.int32(qp),
                                    bit_depth=bit_depth))
        got_d = port.dequant_batch(got, qp, bit_depth)
        np.testing.assert_array_equal(got_d.numpy(), want_d,
                                      err_msg=f"qp {qp}")
    # dequant over the full level range (not only quant's outputs)
    lev = np.random.default_rng(7).integers(-32767, 32768, (4, size, size))
    for qp in (0, 17, 37, 51, 63):
        want_d = np.asarray(dqbatch(jnp.asarray(lev.astype(np.int32)),
                                    jnp.int32(qp), bit_depth=bit_depth))
        got_d = port.dequant_batch(torch.from_numpy(lev.astype(np.int32)),
                                   qp, bit_depth)
        np.testing.assert_array_equal(got_d.numpy(), want_d)


def test_level_bits_bit_equal_for_every_level():
    import torch
    from vvc_torch.cabac import rates as port
    a = np.arange(32768, dtype=np.int32)
    want = np.asarray(jax.jit(ref_rates.level_bits_jnp)(jnp.asarray(a)))
    got = port.level_bits(torch.from_numpy(a))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))


@pytest.mark.parametrize("size", (8, 16, 32, 64))
def test_quant_rate_matches_its_parts(size):
    import torch
    from vvc_torch.kernels import quant as port
    coeff = _coeffs(size, 3 * size)
    for qp in (12, 32, 45):
        rate, deq = port.quant_rate(torch.from_numpy(coeff), qp, 8)
        want_l = np.asarray(ref.quant_batch(jnp.asarray(coeff), qp, 8,
                                            intra=True))
        np.testing.assert_array_equal(
            deq.numpy(), np.asarray(ref.dequant_batch(jnp.asarray(want_l),
                                                      qp, 8)))
        bits = np.asarray(jax.jit(ref_rates.level_bits_jnp)(
            jnp.abs(jnp.asarray(want_l)))).astype(np.float64)
        assert rate.dtype == torch.float32
        np.testing.assert_allclose(rate.numpy(), bits.sum(axis=(1, 2)),
                                   rtol=size * size * 2.0 ** -24)


@pytest.mark.parametrize("size", (8, 16, 32, 64))
def test_quant_rate_inter_dead_zone_equal(size):
    """quant_rate(intra=False), the inter search's pass: the levels behind
    its dequantised block are vvc's quant_batch(intra=False) (dead zone
    85/512) at QPs 0..63, the rate is theirs within the float32 bound;
    and the inter offset really changes levels (intra would differ)."""
    import torch
    from vvc_torch.kernels import quant as port
    coeff = _coeffs(size, 5 * size)
    qbatch = jax.jit(ref.quant_batch, static_argnames=("bit_depth",
                                                       "intra"))
    differs = False
    for qp in range(0, 64, 3):
        rate, deq = port.quant_rate(torch.from_numpy(coeff), qp, 8,
                                    intra=False)
        want_l = np.asarray(qbatch(jnp.asarray(coeff), jnp.int32(qp),
                                   bit_depth=8, intra=False))
        np.testing.assert_array_equal(
            port.quant_batch(torch.from_numpy(coeff), qp, 8,
                             intra=False).numpy(), want_l)
        np.testing.assert_array_equal(
            deq.numpy(), np.asarray(ref.dequant_batch(jnp.asarray(want_l),
                                                      qp, 8)))
        bits = np.asarray(jax.jit(ref_rates.level_bits_jnp)(
            jnp.abs(jnp.asarray(want_l)))).astype(np.float64)
        np.testing.assert_allclose(rate.numpy(), bits.sum(axis=(1, 2)),
                                   rtol=size * size * 2.0 ** -24)
        intra_deq = port.quant_rate(torch.from_numpy(coeff), qp, 8)[1]
        differs |= not torch.equal(intra_deq, deq)
    assert differs

"""Port of the 67-mode intra prediction and the RDO reference lines
(vvc_torch.kernels.intra, vvc_torch.enc.rdo) against vvc's numpy oracles.

Tolerance: exact equality (integer semantics)."""
import numpy as np
import pytest

from vvc.kernels import intra as ref_intra

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

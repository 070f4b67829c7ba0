"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked `cuda`: they skip where no CUDA device is present (the CPU
test run) and run on the GPU machine with

    python -m pytest tests/test_torch_cuda.py -q -m cuda

Tolerance: exact equality (integer kernels)."""
import numpy as np
import pytest

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    return torch.device("cuda")


def _both(fn, *args):
    import torch
    from vvc_torch import ops
    got = fn(*args)
    with ops.plain():
        want = fn(*args)
    torch.cuda.synchronize()
    return got, want


@pytest.mark.parametrize("bit_depth", (8, 10))
@pytest.mark.parametrize("size", (4, 8, 16, 32, 64))
def test_kernels_equal_plain(dev, size, bit_depth):
    import torch
    from vvc_torch import ops
    from vvc_torch.enc import rdo
    from vvc_torch.kernels import intra, satd
    rng = np.random.default_rng(size + bit_depth)
    plane = torch.from_numpy(rng.integers(0, 1 << bit_depth, (96, 160))
                             .astype(np.int32)).to(dev)
    xs = torch.from_numpy(rng.integers(0, 160, 64).astype(np.int32)).to(dev)
    ys = torch.from_numpy(rng.integers(0, 96, 64).astype(np.int32)).to(dev)
    xs[:8] = 0
    ys[4:12] = 0
    before = dict(ops.COUNTS)
    refs, want = _both(rdo.build_ref_lines_device, plane, xs, ys, size,
                       bit_depth)
    assert torch.equal(refs, want)
    preds, want = _both(intra.predict_all_modes_batch, refs, size,
                        bit_depth)
    assert torch.equal(preds, want)
    orig = torch.from_numpy(rng.integers(0, 1 << bit_depth, (64, size, size))
                            .astype(np.int32)).to(dev)
    got, want = _both(satd.satd_batch, preds, orig)
    assert torch.equal(got, want)
    assert all(ops.COUNTS[k] == before[k] + 1 for k in ops.COUNTS)


@pytest.mark.parametrize("h,w", [(4, 8), (8, 4), (16, 8), (8, 32)])
def test_satd_rect_equal_plain(dev, h, w):
    import torch
    from vvc_torch.kernels import satd
    rng = np.random.default_rng(h * w)
    pred = torch.from_numpy(rng.integers(0, 1024, (9, 5, h, w))
                            .astype(np.int32)).to(dev)
    orig = torch.from_numpy(rng.integers(0, 1024, (9, h, w))
                            .astype(np.int32)).to(dev)
    got, want = _both(satd.satd_batch, pred, orig)
    assert torch.equal(got, want)


def test_wrapper_rejects_int64(dev):
    import torch
    from vvc_torch.kernels import satd
    with pytest.raises(TypeError):
        satd.satd_batch(torch.zeros((2, 3, 8, 8), dtype=torch.int64,
                                    device=dev),
                        torch.zeros((2, 8, 8), dtype=torch.int64, device=dev))

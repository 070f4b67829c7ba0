"""Port of the intra RDO search (vvc_torch.enc.rdo), lossless and lossy
(MTS + MIP RD), against vvc.enc.rdo on the CPU backend.  Tolerance:
bit-exact — the packed search vector carries float32 costs that the host
DP compares bit for bit, at every block size 8..64."""
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


@pytest.mark.parametrize("qp", (22, 32, 37))
def test_lossy_packed_search_vector_bit_equal(frame, port, qp):
    """Lossy MTS + MIP search (LFNST and chroma off): costs, modes and MTS
    choices of every size 8..64 bit-equal to vvc's jitted program."""
    import torch
    vec = ref.pack_planes(frame.y)
    want = np.asarray(ref.eval_all_sizes(jnp.asarray(vec), SHAPES,
                                         jnp.int32(qp), 8, W, H, False,
                                         False, False, False))
    got = port.eval_all_sizes(torch.from_numpy(vec), SHAPES, qp, 8, W, H,
                              False, False, False, False).numpy()
    tail = sum(6 * (H // 32) * (W // 32) for _ in ref._tt_descriptors(SHAPES))
    assert len(want) == len(got) + tail
    np.testing.assert_array_equal(got, want[:len(got)])
    res = port.unpack_results(got, SHAPES, W, H)
    assert any((r[1] >= 67).any() for r in res.values())      # MIP won
    assert any((r[2] > 0).any() for r in res.values())        # MTS won


def test_eval_blocks_top3_tie_keeps_lower_index(port):
    """Flat reference lines make every angular, DC, planar and MIP
    prediction the same, so the SATD prescreen ties across modes and
    `lax.top_k` keeps the lower index: planar, DC, then the first MIP
    mode.  The port's stable shortlist must pick the same three."""
    import torch
    s = 16
    rng = np.random.default_rng(3)
    orig = (128 + rng.integers(-3, 4, (6, s, s))).astype(np.int32)
    refs = np.full((6, 4 * s + 3), 128, dtype=np.int32)
    refs[3:] = 90
    fn = jax.jit(ref.eval_blocks, static_argnames=(
        "size", "bit_depth", "try_mts", "lossless", "try_mip", "try_lfnst"))
    want = fn(jnp.asarray(orig), jnp.asarray(refs), size=s, qp=32,
              bit_depth=8, try_mts=True, lossless=False, try_mip=True,
              try_lfnst=False)
    got = port.eval_blocks(torch.from_numpy(orig), torch.from_numpy(refs), s,
                           32, 8, try_mts=True, lossless=False, try_mip=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().view(np.int32),
                                      np.asarray(w).view(np.int32))
    lam, sqrt_lam = port.lambda_f32(32)
    satd = torch.zeros((1, 76), dtype=torch.float64)
    bits = np.concatenate([port._MODE_BITS, np.full(9, port._MIP_BITS,
                                                    np.float32)])
    pre = (satd + float(sqrt_lam) * torch.from_numpy(bits.astype(np.float64))
           ).to(torch.float32)
    short = torch.sort(pre, dim=1, stable=True).indices[0, :3].tolist()
    assert short == [0, 1, 67]


@pytest.mark.parametrize("size, bit_depth", ((8, 10), (16, 10), (32, 8),
                                             (64, 8)))
def test_sse_above_2_24_bit_equal(port, monkeypatch, size, bit_depth):
    """Blocks whose SSE reaches 2^24, where float32 partial sums round and
    the port takes XLA's summation order.  At 16..64, binary-noise
    originals over flat reference lines at QP 63 leave most of the noise
    uncoded; eval_blocks must then be bit-equal to vvc's jitted program
    (a sequential sum order breaks it).  At 8×8 no input we constructed
    drives the fused program there: each coefficient's error stays below
    0.67 of a quantiser step, so nearly all 64 would have to sit at that
    limit at once.  The 8×8 order is held instead against vvc's jitted sum
    of d·d on differences drawn directly, where the sequential order
    differs."""
    import torch
    rng = np.random.default_rng(size)
    mx = (1 << bit_depth) - 1
    if size == 8:
        d = rng.integers(-mx, mx + 1, (2000, 8, 8)).astype(np.int32)
        df = jnp.asarray(d).astype(jnp.float32)
        want = np.asarray(jax.jit(lambda x: jnp.sum(x * x, axis=(1, 2)))(df))
        got = port._sse_f32(torch.from_numpy(d)).numpy()
        exact = (d.astype(np.int64) ** 2).sum(axis=(1, 2))
        assert (exact >= 1 << 24).sum() > 1000
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))
        seq = np.zeros(len(d), np.float32)
        for v in (d.reshape(len(d), -1).astype(np.float32) ** 2).T:
            seq = seq + v
        assert (seq != want).any()
        return
    big = []
    sse_f32 = port._sse_f32

    def counted(d):
        dl = d.to(torch.int64)
        big.append(int(((dl * dl).sum(dim=(1, 2)) >= 1 << 24).sum()))
        return sse_f32(d)

    monkeypatch.setattr(port, "_sse_f32", counted)
    n, small = 8, size <= 32
    orig = (rng.integers(0, 2, (n, size, size)) * mx).astype(np.int32)
    refs = np.repeat(rng.integers(0, mx + 1, (n, 1)), 4 * size + 3,
                     axis=1).astype(np.int32)
    fn = jax.jit(ref.eval_blocks, static_argnames=(
        "size", "bit_depth", "try_mts", "lossless", "try_mip", "try_lfnst"))
    want = fn(jnp.asarray(orig), jnp.asarray(refs), size=size, qp=63,
              bit_depth=bit_depth, try_mts=small, lossless=False,
              try_mip=small, try_lfnst=False)
    got = port.eval_blocks(torch.from_numpy(orig), torch.from_numpy(refs),
                           size, 63, bit_depth, try_mts=small,
                           lossless=False, try_mip=small)
    assert sum(big) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().view(np.int32),
                                      np.asarray(w).view(np.int32))


@pytest.mark.parametrize("kw,match", [
    ({"lossless": False, "lfnst": True}, "slice 2b"),
    ({"lossless": False, "lfnst": False, "chroma_planes": "frame"},
     "slice 2b"),
    ({"lossless": False, "lfnst": False, "isp": True}, "slice 2c"),
    ({"lossless": True, "mtt": True}, "slice 2c")],
    ids=["lfnst", "cclm", "isp", "mtt"])
def test_lossy_and_mtt_raise_not_implemented(frame, port, kw, match):
    if kw.get("chroma_planes") == "frame":
        kw = dict(kw, chroma_planes=(frame.cb, frame.cr))
    with pytest.raises(NotImplementedError, match=match):
        port.rdo_partition(frame.y, 32, 8, device="cpu", **kw)

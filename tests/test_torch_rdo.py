"""Port of the intra RDO search (vvc_torch.enc.rdo), lossless and lossy
(MTS + MIP RD; LFNST and the device chroma decision), against
vvc.enc.rdo on the CPU backend.  Tolerance: bit-exact — the packed search
vector carries float32 costs that the host DP compares bit for bit, at
every block size 8..64."""
import ctypes
import gc
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vvc.enc import rdo as ref
from vvc.io.synth import synth_frame

# torch and vvc_torch are imported inside the tests, so that a test worker
# that never runs them does not load torch beside JAX.


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread while this module runs: the suite runs in
    several worker processes at once, and torch's default of one thread
    per core in each of them oversubscribes the cores."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def release_jax_programs():
    """Drop vvc's compiled programs when the test ends.  Each lossy search
    program holds about 0.4 GiB in the worker process that compiled it
    until the process exits; few of the port's tests share one, so a
    dropped program is seldom compiled again."""
    yield
    jax.clear_caches()
    gc.collect()
    try:
        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except (OSError, AttributeError):
        pass


W, H = 128, 64
SEEDS_2_24 = 4
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

    def counted(d, **order):
        dl = d.to(torch.int64)
        big.append(int(((dl * dl).sum(dim=(1, 2)) >= 1 << 24).sum()))
        return sse_f32(d, **order)

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
    ({"lossless": False, "lfnst": False, "isp": True}, "square-only"),
    ({"lossless": True, "mtt": True}, "square-only")],
    ids=["isp", "mtt"])
def test_lossy_and_mtt_raise_not_implemented(frame, port, kw, match):
    """ISP and the MTT lattice run since slice 2c: the search tiles the
    frame with leaves of the lattice's shapes.  What still raises is a
    square-only tool asked for on a rect shape (vvc asserts the same)."""
    import torch
    _, _, leaves = port.rdo_partition(frame.y, 32, 8, device="cpu", **kw)
    assert sum(l.w * l.h for l in leaves) == W * H
    if kw.get("mtt"):
        assert any(l.w != l.h for l in leaves)
    orig = torch.zeros((1, 8, 16), dtype=torch.int32)
    refs = torch.zeros((1, 2 * 8 + 2 * 16 + 3), dtype=torch.int32)
    with pytest.raises(ValueError, match=match):
        port.eval_blocks(orig, refs, 16, 32, 8, try_mip=True, h=8)


# ---------------------------------------------------------------------------
# Slice 2b: LFNST (stage C) and the device chroma decision
# ---------------------------------------------------------------------------


def smooth_frame(w=128, h=128, t=0):
    """Smooth luma and flat chroma, built like tests/test_lfnst.py
    _smooth_frames: content on which the search picks LFNST."""
    ys, xs = np.mgrid[0:h, 0:w]
    y = (60 + 0.8 * xs + 0.4 * ys
         + 12 * np.sin(xs / 40.0 + t) * np.cos(ys / 37.0)).astype(np.int32)
    c = np.full((h // 2, w // 2), 110, np.int32)
    return y, c, c + 30


@pytest.fixture(scope="module")
def ref_2b():
    """vvc's packed 2b search vectors, memoised per (content, qp) so that
    the cases of this module share one compiled program per shape."""
    cache = {}

    def get(planes, w, h, qp, bit_depth=8):
        key = (w, h, qp, bit_depth, b"".join(np.ascontiguousarray(p).tobytes()
                                             for p in planes))
        if key not in cache:
            vec = ref.pack_planes(*planes)
            cache[key] = (vec, np.asarray(ref.eval_all_sizes(
                jnp.asarray(vec), ref._candidate_shapes(64, 8, False),
                jnp.int32(qp), bit_depth, w, h, False, True, True, False)))
        return cache[key]
    return get


@pytest.fixture(scope="module")
def smooth():
    return smooth_frame()


def _check_2b_vector(port, vec, want, w, h, qp, bit_depth=8):
    import torch
    shapes = ref._candidate_shapes(64, 8, False)
    got = port.eval_all_sizes(torch.from_numpy(vec), shapes, qp, bit_depth,
                              w, h, False, True, True, False).numpy()
    tail = sum(6 * (h // 32) * (w // 32) for _ in ref._tt_descriptors(shapes))
    assert len(want) == len(got) + tail
    np.testing.assert_array_equal(got, want[:len(got)])
    return port.unpack_results(got, shapes, w, h)


@pytest.mark.usefixtures("release_jax_programs")
def test_2b_packed_search_vector_bit_equal(frame, port, ref_2b):
    """LFNST and the chroma decision on (lfnst=True, with chroma planes):
    costs, modes, MTS, LFNST and chroma modes of every size bit-equal to
    vvc's jitted program at QP 22, 32 and 37 (one test, so that the three
    share one compile of vvc's program)."""
    planes = (frame.y, frame.cb, frame.cr)
    for qp in (22, 32, 37):
        vec, want = ref_2b(planes, W, H, qp)
        res = _check_2b_vector(port, vec, want, W, H, qp)
        cm = np.concatenate([r[4].ravel() for r in res.values()])
        assert set(np.unique(cm)) >= {0, 1}       # DM and LM both chosen


@pytest.mark.usefixtures("release_jax_programs")
def test_2b_packed_vector_smooth_lfnst_wins(port, ref_2b, smooth):
    """Smooth content at QP 37, where stage C wins: the LFNST plane is
    non-zero, so its costs (rate sum order, folded bit constants, FMA)
    are compared bit for bit."""
    vec, want = ref_2b(smooth, 128, 128, 37)
    res = _check_2b_vector(port, vec, want, 128, 128, 37)
    assert sum(int((r[3] > 0).sum()) for r in res.values()) > 0


@pytest.mark.usefixtures("release_jax_programs")
def test_2b_rdo_partition_tiled_leaves_equal(port):
    """Two tile columns with chroma: each tile searched on its own planes,
    its downsampled luma clamped at the tile's own left edge."""
    from vvc.enc.encoder import tile_columns
    f = synth_frame(W, H, 2)
    tiles = tile_columns(2, W, 64)
    key = lambda l: (l.x0, l.y0, l.w, l.h, l.luma_mode, l.mts, l.lfnst,
                     l.isp, l.chroma_mode)
    _, _, want = ref.rdo_partition_tiled(f.y, tiles, 32, 8,
                                         chroma_planes=(f.cb, f.cr))
    _, _, got = port.rdo_partition_tiled(f.y, tiles, 32, 8,
                                         chroma_planes=(f.cb, f.cr),
                                         device="cpu")
    assert [key(l) for l in got] == [key(l) for l in want]
    assert any(l.x0 >= 64 and l.chroma_mode for l in got)


@pytest.mark.parametrize("size", (8, 16, 32, 64))
def test_eval_chroma_modes_equal(frame, port, size):
    """The 4-way chroma decision of one block size against vvc's jitted
    eval_chroma_modes, with luma modes drawn from the angular and MIP
    ranges (MIP maps to planar for DM)."""
    import torch
    from vvc.kernels.cclm import luma_ds_plane_jnp
    rng = np.random.default_rng(size)
    ny, nx = H // size, W // size
    ys = (np.repeat(np.arange(ny), nx) * size).astype(np.int32)
    xs = (np.tile(np.arange(nx), ny) * size).astype(np.int32)
    modes = rng.integers(0, 76, len(xs)).astype(np.int32)
    ds = luma_ds_plane_jnp(jnp.asarray(frame.y))
    fn = jax.jit(ref.eval_chroma_modes, static_argnames=("size",
                                                         "bit_depth"))
    want = np.asarray(fn(jnp.asarray(frame.cb), jnp.asarray(frame.cr), ds,
                         jnp.asarray(xs), jnp.asarray(ys), size=size,
                         best_mode=jnp.asarray(modes), bit_depth=8))
    t = lambda a: torch.from_numpy(np.array(a, dtype=np.int32))
    got = port.eval_chroma_modes(t(frame.cb), t(frame.cr), t(np.asarray(ds)),
                                 t(xs), t(ys), size, t(modes), 8).numpy()
    np.testing.assert_array_equal(got, want)


def tied_chroma(h, w, rng, bit_depth=10):
    """A chroma plane whose rows and columns 3 mod 4 are 0 and whose other
    samples lie in the top quarter of the range.  Every chroma block of 4×4
    and up then sees all-zero neighbours, so DM and the three LM models
    all predict 0 (blocks with neighbours); the four integer SSEs are
    equal and pass 2^24 at 8×8 and above, and the decision rests on the
    order of each float32 sum alone."""
    mx = (1 << bit_depth) - 1
    p = rng.integers(mx - 255, mx + 1, (h, w)).astype(np.int32)
    p[3::4, :] = 0
    p[:, 3::4] = 0
    return p


def _swap_chroma_order(monkeypatch, port, which):
    """Sum the DM (which = 0) or the LM (which = 1) chroma SSEs in the other
    of the two orders.  eval_chroma_modes asks for the 4 sums of a plane in
    turn, DM first; the luma SSE, asked for without row lanes (at most a
    part order), is left alone."""
    sse = port._sse_f32
    calls = itertools.count()

    def swapped(d, row_lanes=None, **order):
        if row_lanes is not None and (next(calls) % 4 > 0) == bool(which):
            row_lanes = not row_lanes
        return sse(d, row_lanes, **order)
    monkeypatch.setattr(port, "_sse_f32", swapped)


@pytest.mark.parametrize("size", (16, 32, 64))
def test_eval_chroma_modes_above_2_24_equal(port, monkeypatch, size):
    """10-bit chroma sums at or above 2^24 (8×8, 16×16 and 32×32 chroma
    blocks): the decision bit-equal to vvc's jitted eval_chroma_modes on
    128×128, where every size has blocks with a row above and a column to
    the left, over several seeds of tied content.  With each chroma sum
    taken in its other order, the DM sums or the LM sums, the port decides
    otherwise somewhere, so the test holds both orders.  (At 32×32 both
    are summed along the columns, and the row-lane sum of this content
    comes out below it, so a DM sum taken along the rows still wins every
    tie: only the LM swap shows there.)"""
    import torch
    from vvc.kernels.cclm import luma_ds_plane_jnp
    w = h = 128
    fn = jax.jit(ref.eval_chroma_modes, static_argnames=("size",
                                                         "bit_depth"))
    t = lambda a: torch.from_numpy(np.array(a, dtype=np.int32))
    ny, nx = h // size, w // size
    ys = (np.repeat(np.arange(ny), nx) * size).astype(np.int32)
    xs = (np.tile(np.arange(nx), ny) * size).astype(np.int32)
    swapped = [0, 0]
    for seed in range(SEEDS_2_24):
        rng = np.random.default_rng(seed)
        y = rng.integers(0, 1024, (h, w)).astype(np.int32)
        cb, cr = (tied_chroma(h // 2, w // 2, rng) for _ in range(2))
        modes = rng.integers(0, 76, len(xs)).astype(np.int32)
        ds = luma_ds_plane_jnp(jnp.asarray(y))
        want = np.asarray(fn(jnp.asarray(cb), jnp.asarray(cr), ds,
                             jnp.asarray(xs), jnp.asarray(ys), size=size,
                             best_mode=jnp.asarray(modes), bit_depth=10))
        args = (t(cb), t(cr), t(ds), t(xs), t(ys), size, t(modes), 10)
        np.testing.assert_array_equal(port.eval_chroma_modes(*args).numpy(),
                                      want)
        for which in (0, 1):
            with monkeypatch.context() as m:
                _swap_chroma_order(m, port, which)
                swapped[which] += int((port.eval_chroma_modes(*args).numpy()
                                       != want).sum())
    assert swapped[1] > 0 and (swapped[0] > 0 or size == 64), swapped


@pytest.mark.usefixtures("release_jax_programs")
def test_2b_chroma_sums_above_2_24_bit_equal(port, monkeypatch, ref_2b):
    """The same orders inside vvc's whole search program, at 10 bit on
    128×64: no 64×64 block has a row above, so LM ≡ LM_L and LM_T is the
    no-neighbour constant there.  Binary noise and tied content: the packed
    vectors bit-equal, and with the DM or the LM orders swapped the port's
    chroma modes differ somewhere."""
    import torch
    shapes = ref._candidate_shapes(64, 8, False)
    swapped = [0, 0]
    for seed in range(2):
        rng = np.random.default_rng(seed)
        y = rng.integers(0, 1024, (H, W)).astype(np.int32)
        if seed == 0:
            cb, cr = ((rng.integers(0, 2, (H // 2, W // 2)) * 1023
                       ).astype(np.int32) for _ in range(2))
        else:
            cb, cr = (tied_chroma(H // 2, W // 2, rng) for _ in range(2))
        vec, want = ref_2b((y, cb, cr), W, H, 32, 10)
        got = _check_2b_vector(port, vec, want, W, H, 32, 10)
        for which in (0, 1):
            with monkeypatch.context() as m:
                _swap_chroma_order(m, port, which)
                alt = port.unpack_results(port.eval_all_sizes(
                    torch.from_numpy(vec), shapes, 32, 10, W, H, False, True,
                    True, False).numpy(), shapes, W, H)
            swapped[which] += sum(int((alt[k][4] != got[k][4]).sum())
                                  for k in got)
    assert min(swapped) > 0, swapped


@pytest.mark.parametrize("cs", (4, 8, 16, 32))
def test_chroma_plane_sums_and_cb_cr_add(port, cs):
    """The chroma cost's two float32 roundings, on 10-bit differences:
    each plane's sum of d·d, and the add of the cb and cr costs.  Below
    2^24 a plane sum is exact in any order (a 4×4 block never reaches
    it), so the port's equals vvc's jitted jnp.sum bit for bit; at 8×8 the
    port's order above 2^24 (lanes along rows, then the tree) is jnp's
    too.  Above 2^24 at 16×16 and 32×32 a standalone jnp.sum takes an
    order of its own, neither of the two that the chroma sums of vvc's
    search program take, so those sums are not compared here: the orders of the search program are held
    by test_eval_chroma_modes_above_2_24_equal and
    test_2b_chroma_sums_above_2_24_bit_equal.  The add rounds once, as
    jnp's."""
    import torch
    rng = np.random.default_rng(cs)
    d = rng.integers(-1023, 1024, (2, 400, cs, cs)).astype(np.int32)
    d[:, :200] //= 4 if cs <= 16 else 16    # half of them below 2^24

    def sq_sum(x):
        x = x.astype(jnp.float32)
        return jnp.sum(x * x, axis=(1, 2))

    plane_sum = jax.jit(sq_sum)
    want = [np.asarray(plane_sum(jnp.asarray(p))) for p in d]
    got = [port._sse_f32(torch.from_numpy(p)).numpy() for p in d]
    exact = (d.astype(np.int64) ** 2).sum(axis=(2, 3))
    small = exact < 1 << 24
    assert small.sum() >= 400 and (cs == 4) == small.all()
    held = np.ones_like(small) if cs <= 8 else small
    for g, w, k in zip(got, want, held):
        np.testing.assert_array_equal(g[k].view(np.int32),
                                      w[k].view(np.int32))
    # the cb + cr add: exact plane costs whose total passes 2^24 round
    # once, in float32, as jnp's add
    a, b = (rng.integers(1 << 23, 1 << 24, 1000).astype(np.float32)
            for _ in range(2))
    add = np.asarray(jax.jit(lambda x, y: x + y)(a, b))
    np.testing.assert_array_equal(
        (torch.from_numpy(a) + torch.from_numpy(b)).numpy().view(np.int32),
        add.view(np.int32))
    assert (add.astype(np.int64) != a.astype(np.int64) + b).any()


@pytest.fixture(scope="module")
def ref_frames():
    """vvc's jitted vmapped search (eval_all_sizes_frames) at 10 bit with
    chroma, memoised per (geometry, content)."""
    cache = {}

    def get(vec, w, h, f):
        key = (w, h, f, vec.tobytes())
        if key not in cache:
            cache[key] = np.asarray(ref.eval_all_sizes_frames(
                jnp.asarray(vec), SHAPES, jnp.int32(32), 10, w, h, f, False,
                True, True, False))
        return cache[key]
    return get


@pytest.mark.usefixtures("release_jax_programs")
@pytest.mark.parametrize("w,h,seeds", [(64, 64, (0, 2)), (64, 128, (0, 2))],
                         ids=["64x64_tiles", "64x128_tiles"])
def test_tiled_chroma_sums_above_2_24_bit_equal(port, monkeypatch,
                                                 ref_frames, w, h, seeds):
    """The chroma sums of vvc's vmapped tile program (2 tile columns, the
    path of rdo_partition_tiled) on 10-bit tied content, whose sums pass
    2^24 and whose decisions rest on their float32 order: the packed
    vectors bit-equal.  With the single-frame orders instead (as the port
    took them before), the vectors differ."""
    import torch
    from tests.sweep_torch_chroma_orders import planes
    impl = port._eval_all_sizes_impl
    old = 0
    for seed in seeds:
        rng = np.random.default_rng(seed)
        tiles = [planes(w, h, rng, "tied") for _ in range(2)]
        vec = ref.pack_planes(*(np.stack(p) for p in zip(*tiles)))
        want = ref_frames(vec, w, h, 2)
        got = port.eval_all_sizes_frames(
            torch.from_numpy(vec), SHAPES, 32, 10, w, h, 2, False, True,
            True, False).numpy()
        np.testing.assert_array_equal(got, want[:, :got.shape[1]])
        with monkeypatch.context() as m:
            m.setattr(port, "_eval_all_sizes_impl",
                      lambda *a, **k: impl(*a, **{**k, "vmapped": False}))
            alt = port.eval_all_sizes_frames(
                torch.from_numpy(vec), SHAPES, 32, 10, w, h, 2, False, True,
                True, False).numpy()
        old += int((alt != got).sum())
    assert old > 0

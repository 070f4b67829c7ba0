"""The port's sharded path (vvc_torch.shard: the launcher, mesh, halo
exchange, tile-edge deblock and the sharded encode) against vvc.shard on
the 8-virtual-device CPU mesh of tests/conftest.py.  The port's ranks are
gloo processes on the CPU (vvc_torch.shard.launch.run_ranks), torch on one
thread each; every multi-rank call has its own time limit (the launcher's
join limit, which is also the process group's timeout).  Tolerance:
exact, but for sharded_rdo_step's cross-rank float32 total, held with
vvc's own rtol=1e-5 (tests/test_shard.py)."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from vvc.io.synth import synth_frame
from vvc.io.yuv import Frame
from vvc.shard import encode as ref_encode
from vvc.shard import filter as ref_filter
from vvc.shard import halo as ref_halo
from vvc.shard import mesh as ref_mesh

from tests.test_torch_rdo import (  # noqa: F401
    _one_torch_thread, release_jax_programs)

# torch and vvc_torch are imported inside the tests, so that a test worker
# that never runs them does not load torch beside JAX.

RANK_LIMIT_S = 300          # one multi-rank call: spawn, search, gather


def _ranks(fn, n, *args, **kw):
    from vvc_torch.shard.launch import run_ranks
    return run_ranks(fn, n, "gloo", "cpu", RANK_LIMIT_S, *args, threads=1,
                     **kw)


def _tile_mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("tile",))


# ---------------------------------------------------------------------------
# _filter_edge_cols: the plain twin of the tile_edge_deblock kernel
# ---------------------------------------------------------------------------


def _windows(rng, n_seg, bit_depth):
    """[4·n_seg, 8] edge windows, 4 rows per segment: sides that are flat,
    sloped, noisy or textured, with steps from 0 to past the filters'
    thresholds, so that strong, normal (with and without the side taps)
    and off segments all occur."""
    s = 1 << (bit_depth - 8)
    mx = (1 << bit_depth) - 1
    i = np.arange(4)
    rows = []
    for _ in range(n_seg):
        base = rng.integers(16 * s, mx - 64 * s)
        step = int(rng.choice([0, 1, 2, 4, 8, 16, 40])) * s
        slope_p, slope_q = (int(rng.choice([0, 0, 1, 3])) * s
                            for _ in range(2))
        sigma = float(rng.choice([0, 0, 0.5, 1, 3, 30])) * s
        p = base + slope_p * i[::-1]                      # p3 .. p0
        q = base + step + slope_q * i                     # q0 .. q3
        seg = np.concatenate([p, q])[None, :] + rng.normal(0, sigma, (4, 8))
        rows.append(np.clip(np.rint(seg), 0, mx))
    return np.concatenate(rows).astype(np.int32)


def _classes(seg, out):
    """Per-segment filter class from what changed: 3 strong (p2 or q2),
    2 normal with a side tap (p1 or q1), 1 normal (p0 or q0), 0 off."""
    ch = (seg != out).reshape(-1, 4, 8).any(axis=1)
    return np.where(ch[:, 1] | ch[:, 6], 3, np.where(
        ch[:, 2] | ch[:, 5], 2, np.where(ch[:, 3] | ch[:, 4], 1, 0)))


@pytest.mark.parametrize("bit_depth", (8, 10))
def test_filter_edge_cols_equal_vvc(bit_depth):
    """The plain twin equals vvc's jitted _filter_edge_cols on constructed
    windows at QP 0..63 (every third, and 63), tC = 0 at the low QPs
    included; strong, normal, side and off segments all occur."""
    import torch
    from vvc_torch.shard.filter import _filter_edge_cols, edge_params
    rng = np.random.default_rng(bit_depth)
    ref = jax.jit(ref_filter._filter_edge_cols)
    seen = set()
    for qp in list(range(0, 64, 3)) + [63]:
        beta, tc, maxv = edge_params(qp, bit_depth)
        seg = _windows(rng, 256, bit_depth)
        want = np.asarray(ref(jnp.asarray(seg), jnp.int32(beta),
                              jnp.int32(tc), jnp.int32(maxv)))
        got = _filter_edge_cols(torch.from_numpy(seg), beta, tc,
                                maxv).numpy()
        np.testing.assert_array_equal(got, want)
        cls = set(_classes(seg, got).tolist())
        if tc == 0:
            assert cls <= {0, 3}        # tC = 0: no normal filter acts
        seen |= cls
    assert seen == {0, 1, 2, 3}


# ---------------------------------------------------------------------------
# halo exchange and the tile-edge deblock on 2 and 4 ranks
# ---------------------------------------------------------------------------


def _stripes(rng, t, h, wt, bit_depth):
    """Smooth stripes with a step at each tile boundary that varies by
    4-row group, plus light noise in some groups: edges that filter."""
    s = 1 << (bit_depth - 8)
    x = np.arange(t * wt)[None, :]
    y = np.arange(h)[:, None]
    frame = 100 * s + (x // wt) * rng.integers(0, 12, (h // 4, 1)).repeat(
        4, 0) * s + (x + y) // 16
    frame = frame + (rng.random((h // 4, 1)) < 0.3).repeat(4, 0) \
        * rng.integers(0, 3 * s + 1, (h, t * wt))
    frame = np.clip(frame, 0, (1 << bit_depth) - 1).astype(np.int32)
    return np.stack([frame[:, i * wt:(i + 1) * wt] for i in range(t)])


def _unsharded(stripes, qp, bit_depth):
    """The port's whole-frame numpy deblock over the boundary edges only."""
    from vvc_torch.kernels.deblock import BETA_TABLE, _filter_luma_edges_v
    t, h, wt = stripes.shape
    frame = np.concatenate(list(stripes), axis=1)
    ev = np.zeros((h, t * wt // 8 - 1), dtype=bool)
    for i in range(1, t):
        ev[:, i * wt // 8 - 1] = True
    beta = int(BETA_TABLE[qp]) << (bit_depth - 8)
    _filter_luma_edges_v(frame, ev, 8, beta, (qp, bit_depth),
                         (1 << bit_depth) - 1)
    return frame


@pytest.mark.parametrize("n", (2, 4))
def test_halo_and_tile_edge_deblock_equal_vvc(n):
    """exchange_tile_halos (halo 8 and 4) and deblock_tile_edges on n gloo
    ranks equal vvc's on a mesh of n devices (the deblock: 8 bit QP 32 on
    2, 10 bit QP 37 on 4), and the deblock equals the port's unsharded
    _filter_luma_edges_v over the boundary edges in every case (8 bit QP
    32, 10 bit QP 37, 8 bit QP 12 where tC = 0)."""
    from tests import torch_ranks
    from vvc_torch.shard.filter import edge_params
    rng = np.random.default_rng(n)
    stripes = rng.integers(0, 256, (n, 16, 16)).astype(np.int32)
    cases = [(32, 8, _stripes(rng, n, 64, 64, 8)),
             (37, 10, _stripes(rng, n, 64, 64, 10)),
             (12, 8, _stripes(rng, n, 32, 64, 8))]
    got = _ranks(torch_ranks.halo_and_deblock, n, stripes, cases)
    mesh = _tile_mesh(n)
    for halo, (fl, fr) in zip((8, 4), got["halo"]):
        want = ref_halo.exchange_tile_halos(mesh, jnp.asarray(stripes), halo)
        np.testing.assert_array_equal(fl, np.asarray(want[0]))
        np.testing.assert_array_equal(fr, np.asarray(want[1]))
        assert not fl[0].any() and not fr[-1].any()
    for i, ((qp, bd, planes), out) in enumerate(zip(cases, got["deblock"])):
        if i == n // 2 - 1:
            # vvc's deblock runs eagerly, as its own test runs it (about
            # 40 s a call: one case per n); under jax.jit it gives other
            # values than its unsharded pass (ROADMAP §3)
            want = np.asarray(ref_filter.deblock_tile_edges(
                mesh, jnp.asarray(planes), qp, bd))
            np.testing.assert_array_equal(out, want)
        np.testing.assert_array_equal(np.concatenate(list(out), axis=1),
                                      _unsharded(planes, qp, bd))
        # tC = 0 at QP 12: the edges stay as they are
        assert (out != planes).any() == (edge_params(qp, bd)[1] > 0)


def test_sharded_rdo_step_equal_vvc():
    """sharded_rdo_step on 2 ranks: costs and modes bit-equal to vvc's on
    a 2-device mesh (whose 8×8 level-rate sums run along the rows: the
    port's eval_blocks with sharded=True), the total within vvc's own
    rtol=1e-5.  N = 15 is padded to 16."""
    from tests import torch_ranks
    for size, bd in ((8, 8), (8, 10), (16, 8)):
        rng = np.random.default_rng(size + bd)
        orig = rng.integers(0, 1 << bd, (15, size, size)).astype(np.int32)
        refs = rng.integers(0, 1 << bd, (15, 4 * size + 3)).astype(np.int32)
        c, m, tot = _ranks(torch_ranks.rdo_step, 2, orig, refs, size, 32)
        wc, wm, wt = ref_mesh.sharded_rdo_step(
            ref_mesh.make_mesh(2, 1), jnp.asarray(np.concatenate(
                [orig, orig[:1]])), jnp.asarray(np.concatenate(
                    [refs, refs[:1]])), size, 32)
        np.testing.assert_array_equal(c.view(np.int32),
                                      np.asarray(wc)[:15].view(np.int32))
        np.testing.assert_array_equal(m, np.asarray(wm)[:15])
        assert np.isclose(tot, float(np.asarray(wc)[:15].sum()), rtol=1e-5)


# ---------------------------------------------------------------------------
# encode_sequence_sharded
# ---------------------------------------------------------------------------


def test_mesh_shape_is_vvcs_choice():
    from vvc_torch.shard.encode import mesh_shape
    for nf in (1, 2, 5):
        for nt in (1, 2, 3, 4):
            for nd in (1, 2, 3, 4, 8):
                mt = 1
                for c in range(min(nt, nd), 0, -1):
                    if nt % c == 0 and nd % c == 0:
                        mt = c
                        break
                assert mesh_shape(nf, nt, nd) == (min(nf, nd // mt), mt)


def _frames_10bit(w, h, n, seed):
    """10-bit noise luma and tied chroma (tests.sweep_torch_chroma_orders):
    chroma sums past 2^24 whose decisions rest on their float32 order."""
    from tests.sweep_torch_chroma_orders import planes
    rng = np.random.default_rng(seed)
    return [Frame(*planes(w, h, rng, "tied"), 10) for _ in range(n)]


def _port_frames(frames):
    from vvc_torch.io.yuv import Frame as PortFrame
    return [PortFrame(f.y, f.cb, f.cr, f.bit_depth) for f in frames]


def _check_sharded(frames, n_ranks, mesh_fm, kw, with_unsharded):
    from tests import torch_ranks
    (got, recons, _), mods = _ranks(torch_ranks.encode_and_modules, n_ranks,
                                    _port_frames(frames), **kw)
    assert mods == []
    want, want_rec, _ = ref_encode.encode_sequence_sharded(
        frames, mesh=ref_encode.make_encode_mesh(*mesh_fm), **kw)
    assert got == want
    for a, b in zip(want_rec, recons):
        for p, q in zip((a.y, a.cb, a.cr), (b.y, b.cb, b.cr)):
            np.testing.assert_array_equal(p, q)
    if with_unsharded:
        from vvc_torch.enc.encoder import encode_sequence
        single, _, _ = encode_sequence(_port_frames(frames), device="cpu",
                                       **kw)
        assert got == single
    from vvc_torch.dec.decoder import decode_stream
    dec, info = decode_stream(got, device="cpu")
    assert all(info["hash_ok"]) and len(info["hash_ok"]) == len(frames)


@pytest.mark.usefixtures("release_jax_programs")
@pytest.mark.parametrize("n_ranks,mesh_fm", [(1, (1, 1)), (2, (1, 2)),
                                             (4, (2, 2))],
                         ids=["k4", "k2", "k1"])
def test_encode_sequence_sharded_equal_vvc(n_ranks, mesh_fm):
    """128×128, 2 frames, QP 32, 2 tile columns at 1, 2 and 4 ranks (k =
    4, 2, 1 cells a rank): bytes and recons equal to vvc's
    encode_sequence_sharded on the same (frame, tile) mesh shape and to
    the port's single-process encode_sequence; decodes with MD5 OK; no
    JAX or vvc module in a rank."""
    frames = [synth_frame(128, 128, t) for t in range(2)]
    _check_sharded(frames, n_ranks, mesh_fm,
                   dict(qp=32, num_tile_cols=2), True)


@pytest.mark.usefixtures("release_jax_programs")
@pytest.mark.parametrize("n_ranks,mesh_fm", [(2, (1, 2)), (4, (2, 2))],
                         ids=["k2", "k1"])
@pytest.mark.parametrize("case", ["lossless", "ten_bit_noise"])
def test_encode_sequence_sharded_k1_k2(case, n_ranks, mesh_fm):
    """Lossless, and 10-bit noise whose chroma decisions rest on the
    float32 order of sums past 2^24, at k = 1 and k = 2: bytes equal to
    vvc's sharded program on the same mesh shape (and, at 10 bit, its
    search vectors: _check_sharded_vectors)."""
    if case == "lossless":
        frames = [synth_frame(128, 128, t) for t in range(2)]
        kw = dict(qp=32, num_tile_cols=2, lossless=True)
    else:
        frames = _frames_10bit(128, 128, 2, seed=3)
        kw = dict(qp=32, num_tile_cols=2, bit_depth=10)
        _check_sharded_vectors(mesh_fm)
    _check_sharded(frames, n_ranks, mesh_fm, kw, case == "lossless")


def _check_sharded_vectors(mesh_fm):
    """The search vectors of vvc's sharded program (eval_cells_sharded)
    on 10-bit 64×128 cells whose chroma decisions rest on the float32
    order of sums past 2^24 (tied and binary chroma, 4 cells each) are
    bit-equal to the port's chunked search (eval_all_sizes_frames with
    sharded=True, as each rank runs it): its k = 1 orders, the vmapped
    ones at k = 2, and the 8×8 level rates summed along the rows."""
    import torch
    from tests.sweep_torch_chroma_orders import planes
    from vvc.enc.rdo import _candidate_shapes, pack_planes
    from vvc_torch.enc.rdo import eval_all_sizes_frames
    from vvc_torch.shard.encode import _frame_major
    w, h = 64, 128
    shapes = _candidate_shapes(64, 8, False)
    mesh = ref_encode.make_encode_mesh(*mesh_fm)
    k = 4 // (mesh_fm[0] * mesh_fm[1])
    for seed, content in ((0, "tied"), (11, "binary"), (12, "binary")):
        rng = np.random.default_rng(seed)
        cells = np.stack([pack_planes(*planes(w, h, rng, content))
                          for _ in range(4)])
        want = ref_encode.eval_cells_sharded(mesh, cells, shapes, 32, 10, w,
                                             h, False, True, True, False)
        got = np.concatenate([eval_all_sizes_frames(
            torch.from_numpy(_frame_major(cells[c:c + k], w, h, True)),
            shapes, 32, 10, w, h, k, False, True, True, False,
            sharded=True).numpy() for c in range(0, 4, k)])
        # vvc also packs the TT mid planes its QT-only DP never reads
        np.testing.assert_array_equal(got, want[:, :got.shape[1]])


def _mtt_isp_cells(bd, seed, n=8):
    """n packed 128×64 cells (luma and chroma) of content on which the
    MTT lattice and ISP engage: smooth synthetic pictures at 8 bit, tied
    noise (tests.sweep_torch_chroma_orders) at 10 bit."""
    from vvc.enc.rdo import pack_planes
    if bd == 8:
        return np.stack([pack_planes(f.y, f.cb, f.cr) for f in (
            synth_frame(128, 64, seed + t) for t in range(n))])
    from tests.sweep_torch_chroma_orders import planes
    rng = np.random.default_rng(seed)
    return np.stack([pack_planes(*planes(128, 64, rng, "tied"))
                     for _ in range(n)])


def _check_mtt_isp_vectors(mesh_fm, bd):
    """vvc's sharded MTT + ISP search (vvc/shard/encode.py:30
    eval_cells_sharded with the MTT lattice and isp=True) on 8 virtual CPU
    devices against the port's per-rank search (eval_all_sizes_frames with
    sharded=True on each rank's k cells, as eval_cells_sharded runs it):
    the packed vectors bit for bit, rect rates and SSEs included."""
    import torch
    from vvc.enc.rdo import _candidate_shapes
    from vvc_torch.enc.rdo import eval_all_sizes_frames
    from vvc_torch.shard.encode import _frame_major
    w, h = 128, 64
    shapes = _candidate_shapes(64, 8, True)
    mesh = ref_encode.make_encode_mesh(*mesh_fm)
    k = 8 // (mesh_fm[0] * mesh_fm[1])
    cells = _mtt_isp_cells(bd, 3)
    want = ref_encode.eval_cells_sharded(mesh, cells, shapes, 32, bd, w, h,
                                         False, True, True, isp=True)
    got = np.concatenate([eval_all_sizes_frames(
        torch.from_numpy(_frame_major(cells[c:c + k], w, h, True)), shapes,
        32, bd, w, h, k, False, True, True, True, sharded=True).numpy()
        for c in range(0, 8, k)])
    np.testing.assert_array_equal(got, want)


@pytest.mark.usefixtures("release_jax_programs")
def test_sharded_mtt_isp_vector_k1_equal_vvc():
    """k = 1 (8 cells on a (2, 4) mesh), 8 bit: the sharded MTT + ISP
    search vector equals vvc's bit for bit."""
    _check_mtt_isp_vectors((2, 4), 8)


@pytest.mark.slow
@pytest.mark.usefixtures("release_jax_programs")
@pytest.mark.parametrize("mesh_fm,bd", [((1, 4), 8), ((2, 4), 10)],
                         ids=["k2-8bit", "k1-10bit"])
def test_sharded_mtt_isp_vector_equal_vvc(mesh_fm, bd):
    """k = 2 at 8 bit and k = 1 at 10 bit (tied noise, sums past 2^24):
    slow, each compiles vvc's MTT + ISP sharded program anew."""
    _check_mtt_isp_vectors(mesh_fm, bd)


def test_encode_sequence_sharded_mesh_on_some_ranks():
    """On 3 ranks vvc's shape choice for 2 frames of 2 tiles is a (2, 1)
    mesh over ranks 0 and 1: rank 2 only takes part in making it, and the
    stream equals the one of a 2-rank run (k = 2 cells a rank both
    times), and decodes with every MD5 OK."""
    from tests import torch_ranks
    from vvc_torch.dec.decoder import decode_stream
    from vvc_torch.shard.encode import mesh_shape
    assert mesh_shape(2, 2, 3) == (2, 1)
    frames = _port_frames([synth_frame(128, 64, t) for t in range(2)])
    kw = dict(qp=32, num_tile_cols=2)
    (got, _, _), mods = _ranks(torch_ranks.encode_and_modules, 3, frames,
                               **kw)
    (want, _, _), _ = _ranks(torch_ranks.encode_and_modules, 2, frames,
                             **kw)
    assert got == want and mods == []
    _, info = decode_stream(got, device="cpu")
    assert info["hash_ok"] == [True, True]


# ---------------------------------------------------------------------------
# the launcher: a failing or hanging rank ends the run within its limit
# ---------------------------------------------------------------------------


def test_run_ranks_reports_a_failing_rank():
    import time
    from tests import torch_ranks
    from vvc_torch.shard.launch import run_ranks
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        run_ranks(torch_ranks.fail_on_rank_1, 2, "gloo", "cpu", 60)
    assert time.monotonic() - t0 < 60
    assert run_ranks(torch_ranks.rank_of, 3, "gloo", "cpu", 60,
                     threads=1) == (0, 3, "cpu", "gloo", 1)


def test_run_ranks_ends_a_hanging_rank():
    import time
    from tests import torch_ranks
    from vvc_torch.shard.launch import run_ranks
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="did not finish within"):
        run_ranks(torch_ranks.sleep_forever, 2, "gloo", "cpu", 10)
    assert time.monotonic() - t0 < 30

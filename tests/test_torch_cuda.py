"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked `cuda`: they skip where no CUDA device is present (the CPU
test run) and run on the GPU machine (which has no JAX, imported by
tests/conftest.py) with

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

Tolerance: exact equality (integer kernels; the quant_rate kernel's float
rates bit for bit)."""
import numpy as np
import pytest

pytestmark = pytest.mark.cuda

# the kernels only the slice-4b tools launch (affine search, MCTF)
KERNELS_4B = ("affine_search", "affine_dctif", "me_block_err")
# the kernels only the decoder's wavefront path launches
KERNELS_DEC = ("wave_ref_lines", "dequant", "wave_cclm", "wave_commit")
# the kernel only the sharded path's tile-edge deblock launches
KERNELS_SHARD = ("tile_edge_deblock",)
# the kernels only slice 7's functions launch (the r4 engine, the
# Gauss-Newton affine ME, sse_batch / sad_batch)
KERNELS_R4 = ("interp_planes", "phase_gather", "block_dist", "me_full",
              "affine_gn")


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
    assert all(ops.COUNTS[k] == before[k] + 1
               for k in ("ref_lines", "intra_pred_all", "satd"))


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


@pytest.mark.parametrize("bit_depth", (8, 10))
@pytest.mark.parametrize("size", (8, 16, 32, 64))
def test_lossy_kernels_equal_plain(dev, size, bit_depth):
    """transform_fwd → quant_rate (intra and inter dead zone) →
    transform_inv for every MTS pair of the size, and MIP at 8..32:
    kernels against their plain versions; the rates bit for bit."""
    import torch
    from vvc_torch import ops
    from vvc_torch.kernels import mip, quant, transform
    rng = np.random.default_rng(size * bit_depth + 1)
    lim = 1 << bit_depth
    resi = torch.from_numpy(rng.integers(-lim + 1, lim, (300, size, size))
                            .astype(np.int32)).to(dev)
    before = dict(ops.COUNTS)
    pairs = range(len(transform.MTS_TR)) if size <= 32 else (0,)
    for mi in pairs:
        th, tv = transform.MTS_TR[mi]
        coeff, want = _both(transform.fwd_transform_batch, resi, bit_depth,
                            th, tv)
        assert torch.equal(coeff, want)
        for qp in (0, 22, 37, 51, 63):
            for intra in (False, True):      # the inter and intra dead zone
                got, want = _both(quant.quant_rate, coeff, qp, bit_depth,
                                  False, intra)
                assert torch.equal(got[0].view(torch.int32),
                                   want[0].view(torch.int32))
                assert torch.equal(got[1], want[1])
        rec, want = _both(transform.inv_transform_batch, got[1], bit_depth,
                          th, tv)
        assert torch.equal(rec, want)
    if size <= 32:
        refs = torch.from_numpy(rng.integers(0, lim, (200, 4 * size + 3))
                                .astype(np.int32)).to(dev)
        got, want = _both(mip.mip_predict_all_batch, refs, size, bit_depth)
        assert torch.equal(got, want)
    assert ops.COUNTS["quant_rate"] == before["quant_rate"] + 10 * len(pairs)
    assert ops.COUNTS["transform_fwd"] == before["transform_fwd"] + len(pairs)


@pytest.mark.parametrize("qp", (22, 37))
def test_lossy_search_vector_equal_plain(dev, qp):
    import torch
    from vvc_torch import ops
    from vvc_torch.enc import rdo
    from vvc_torch.io.synth import synth_frame
    w, h = 416, 240
    shapes = rdo._candidate_shapes(64, 8, False)
    vec = torch.from_numpy(rdo.pack_planes(synth_frame(w, h, 1).y)).to(dev)
    ops.reset_counts()
    got, want = _both(rdo.eval_all_sizes, vec, shapes, qp, 8, w, h, False,
                      False)
    assert torch.equal(got, want)
    # the seven kernels of slice 2a ran; LFNST and chroma ones did not
    lossy_2a = ("ref_lines", "intra_pred_all", "satd", "transform_fwd",
                "transform_inv", "quant_rate", "mip_pred_all")
    assert all((ops.COUNTS[k] > 0) == (k in lossy_2a) for k in ops.COUNTS)


@pytest.mark.parametrize("size", (8, 16, 32, 64))
def test_lfnst_equal_plain(dev, size):
    """lfnst_fwd / lfnst_inv for every set, both transposes and MIP, and
    quant_rate's 8×8 row-lanes rate order of the LFNST stage."""
    import torch
    from vvc_torch import ops
    from vvc_torch.kernels import lfnst, quant
    rng = np.random.default_rng(size + 5)
    n = 600
    coeff = torch.from_numpy(rng.integers(-32768, 32768, (n, size, size))
                             .astype(np.int32)).to(dev)
    coeff[: n // 2] //= 64
    modes = torch.from_numpy(rng.integers(0, 76, n).astype(np.int32)).to(dev)
    before = dict(ops.COUNTS)
    for li in (1, 2):
        sec, want = _both(lfnst.fwd_lfnst_batch, coeff, modes, li)
        assert torch.equal(sec, want)
        got, want = _both(lfnst.inv_lfnst_batch, sec, modes, li)
        assert torch.equal(got, want)
        if size == 8:
            got, want = _both(quant.quant_rate, sec, 22, 8, True)
            assert torch.equal(got[0].view(torch.int32),
                               want[0].view(torch.int32))
            assert torch.equal(got[1], want[1])
    assert ops.COUNTS["lfnst_fwd"] == before["lfnst_fwd"] + 2
    assert ops.COUNTS["lfnst_inv"] == before["lfnst_inv"] + 2


@pytest.mark.parametrize("bit_depth", (8, 10))
def test_cclm_kernels_equal_plain(dev, bit_depth):
    """luma_ds on a frame and a tile plane; cclm_models for the three
    variants at every chroma size, frame edges and coarse (tied) luma."""
    import torch
    from vvc_torch import ops
    from vvc_torch.kernels import cclm
    rng = np.random.default_rng(bit_depth)
    mx = (1 << bit_depth) - 1
    before = dict(ops.COUNTS)
    for h, w in ((96, 160), (96, 64)):
        luma = torch.from_numpy(rng.integers(0, mx + 1, (h, w))
                                .astype(np.int32)).to(dev)
        ds, want = _both(cclm.luma_ds_plane_dev, luma)
        assert torch.equal(ds, want)
    ds[:8] //= 64
    chroma = torch.from_numpy(rng.integers(0, mx + 1, tuple(ds.shape))
                              .astype(np.int32)).to(dev)
    for cs in (4, 8, 16, 32):
        xs = torch.from_numpy(rng.integers(0, 32, 300).astype(np.int32)
                              ).to(dev)
        ys = torch.from_numpy(rng.integers(0, 48, 300).astype(np.int32)
                              ).to(dev)
        xs[:20] = 0
        ys[10:30] = 0
        for v in (1, 2, 3):
            got, want = _both(cclm.derive_models_batch_dev, ds, chroma, xs,
                              ys, cs, bit_depth, v)
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])
    assert ops.COUNTS["luma_ds"] == before["luma_ds"] + 2
    assert ops.COUNTS["cclm_models"] == before["cclm_models"] + 12


@pytest.mark.parametrize("bit_depth", (8, 10))
@pytest.mark.parametrize("size", (4, 8, 16, 32))
def test_intra_pred_one_equal_plain(dev, size, bit_depth):
    import torch
    from vvc_torch import ops
    from vvc_torch.kernels import intra
    rng = np.random.default_rng(size * bit_depth)
    modes = np.concatenate([np.arange(67), rng.integers(0, 67, 200),
                            [-2, 67, 80]]).astype(np.int32)
    refs = torch.from_numpy(rng.integers(0, 1 << bit_depth,
                                         (len(modes), 4 * size + 3))
                            .astype(np.int32)).to(dev)
    refs[:10] = refs[:10, :1]
    before = ops.COUNTS["intra_pred_one"]
    got, want = _both(intra.predict_modes_batch, refs,
                      torch.from_numpy(modes).to(dev), size, bit_depth)
    assert torch.equal(got, want)
    assert ops.COUNTS["intra_pred_one"] == before + 1


@pytest.mark.parametrize("cols", (1, 2))
def test_2b_search_vector_equal_plain(dev, cols):
    """The 2b search (LFNST and the chroma decision) at 416×240, one frame
    or two tile columns stacked as frames."""
    import torch
    from vvc_torch import ops
    from vvc_torch.enc import rdo
    from vvc_torch.io.synth import synth_frame
    w, h = 416 // cols, 240
    shapes = rdo._candidate_shapes(64, 8, False)
    f = synth_frame(416, h, 2)
    cut = lambda p, k: np.stack([p[:, i * k:(i + 1) * k] for i in range(cols)])
    vec = torch.from_numpy(rdo.pack_planes(cut(f.y, w), cut(f.cb, w // 2),
                                           cut(f.cr, w // 2))).to(dev)
    ops.reset_counts()
    got, want = _both(rdo.eval_all_sizes_frames, vec, shapes, 32, 8, w, h,
                      cols, False, True, True)
    assert torch.equal(got, want)
    # every kernel of the QT-only intra search (the filter statistics run
    # after it; the motion search's kernels belong to the inter search,
    # the rect kernels to the MTT lattice, the slice-4b kernels to the
    # affine search and MCTF)
    assert all(ops.COUNTS[k] > 0 for k in ops.COUNTS
               if k not in ("sao_stats", "alf_stats", "me_prep",
                            "me_coarse", "me_int", "me_qpel",
                            "ref_lines_rect", "intra_pred_all_rect",
                            "intra_pred_one_rect") + KERNELS_4B + KERNELS_R4
               + KERNELS_DEC + KERNELS_SHARD)


@pytest.mark.parametrize("bit_depth,cs,h,w", [(8, 64, 240, 416),
                                             (10, 32, 136, 200),
                                             (8, 32, 540, 960)])
def test_sao_stats_equal_plain(dev, bit_depth, cs, h, w):
    """Per-CTU SAO statistics, exact: partial CTUs at the plane's edges
    and 2 tile columns' validity vectors."""
    import torch
    from vvc_torch import ops
    from vvc_torch.kernels import sao
    rng = np.random.default_rng(bit_depth + cs + h)
    mx = (1 << bit_depth) - 1
    orig = rng.integers(0, mx + 1, (h, w)).astype(np.int32)
    rec = np.clip(orig + rng.integers(-9, 10, (h, w)), 0, mx).astype(np.int32)
    vx = np.ones(w, bool)
    vy = np.ones(h, bool)
    vx[[0, w // 2 - 1, w // 2, w - 1]] = False
    vy[[0, h - 1]] = False
    t = lambda a: torch.from_numpy(a).to(dev)
    before = ops.COUNTS["sao_stats"]
    got, want = _both(sao.sao_stats_dev, t(orig), t(rec), t(vx), t(vy), cs,
                      bit_depth)
    for g, wv in zip(got, want):
        assert g.dtype == torch.float32 and torch.equal(g, wv)
    assert ops.COUNTS["sao_stats"] == before + 1


def _alf_stats_picture(kind, bit_depth, h, w):
    """(orig, rec, cls4, tr4) for test_alf_stats_equal_plain; the maps
    cover the grid (⌈h/4⌉ × ⌈w/4⌉, edge-padded where 4 does not divide)."""
    from vvc_torch.io.synth import synth_frame
    from vvc_torch.kernels import alf
    mx = (1 << bit_depth) - 1
    if kind == "family":
        # tests/test_torch_alf.py's picture(w, h, bit_depth, 160, 0, t=3)
        rng = np.random.default_rng(0)
        orig = synth_frame(w, h, 3).y.astype(np.int32) << (bit_depth - 8)
        rec = orig + rng.integers(-160, 161, orig.shape)
    elif kind == "flat":
        # one texture everywhere: diagonal stripes (period 5) plus noise
        rng = np.random.default_rng(8)
        yy, xx = np.mgrid[0:h, 0:w]
        rec = (100 + np.array([0, 30, 12, 12, 0])[(xx + 3 * yy) % 5]
               + rng.integers(-2, 3, (h, w)))
        orig = (200 + rng.integers(-2, 3, (h, w))).astype(np.int32)
    else:
        rng = np.random.default_rng(bit_depth + h)
        orig = rng.integers(0, mx + 1, (h, w)).astype(np.int32)
        rec = orig + rng.integers(-20, 21, (h, w))
    rec = np.clip(rec, 0, mx).astype(np.int32)
    cls4, tr4 = alf.alf_classify(rec, bit_depth)
    if kind == "keys100":
        cls4 = rng.integers(0, 25, cls4.shape).astype(np.int32)
        tr4 = rng.integers(0, 4, cls4.shape).astype(np.int32)
    pad = ((0, -(-h // 4) - cls4.shape[0]), (0, -(-w // 4) - cls4.shape[1]))
    return orig, rec, np.pad(cls4, pad, "edge"), np.pad(tr4, pad, "edge")


@pytest.mark.parametrize("bit_depth,h,w,kind", [
    pytest.param(8, 240, 416, "noise", id="8-240-416"),
    pytest.param(10, 136, 200, "noise", id="10-136-200"),
    pytest.param(8, 1080, 1920, "noise", id="8-1080-1920"),
    pytest.param(10, 64, 128, "noise", id="10-64-128"),
    pytest.param(8, 1080, 1920, "flat", id="flat-8-1080-1920"),
    pytest.param(8, 240, 416, "keys100", id="keys100-8-240-416"),
    pytest.param(10, 1080, 1920, "family", id="family-10-1080-1920"),
    pytest.param(8, 128, 128, "noise", id="8-128-128"),
    pytest.param(10, 112, 146, "noise", id="10-112-146")])
def test_alf_stats_equal_plain(dev, bit_depth, h, w, kind):
    """ALF statistics, bit-equal to the plain twin (exact sums rounded once
    to float32; B100 in vvc's GEMV order from 4096 grid points on, which
    64×128 and 112×146 (4088 points) stay below and 128×128 (4096) reaches).
    136×200's grid (68×100) leaves partial 32×32 tiles; "flat" puts 99 % of
    the points in one key, every row of which the ordered walk decides
    (the longest chain); "keys100" gives every key points in most tiles;
    "family" is tests/test_torch_alf.py's 1080p 10-bit picture, where the
    walk decides some entries."""
    import torch
    from vvc_torch import ops
    from vvc_torch.kernels import alf
    orig, rec, cls4, tr4 = _alf_stats_picture(kind, bit_depth, h, w)
    if kind == "keys100":
        assert np.unique(cls4 * 4 + tr4).size == 100
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    before = ops.COUNTS["alf_stats"]
    got, want = _both(alf.alf_stats_dev, t(orig), t(rec), t(cls4), t(tr4))
    for g, wv in zip(got, want):
        assert g.dtype == torch.float32 and torch.equal(g, wv)
    assert ops.COUNTS["alf_stats"] == before + 1
    assert float(got[3].sum()) == ((h + 1) // 2) * ((w + 1) // 2)


@pytest.mark.parametrize("h,w", [(48, 64), (45, 67), (240, 416)])
def test_me_prep_coarse_equal_plain(dev, h, w):
    """me_prep (padded + ds4 planes) and me_coarse (grids for 16, 32, 64,
    two refs) against their plain twins, on noise, on a flat picture
    (where the MV bias decides) and on a picture whose ds4 columns
    ≡ 0, 3, 5, 6 (mod 8) are raised, where dx = -1 and +1 tie in the 4×4
    cells starting at ds4 column ≡ 0 (mod 8): the two sit in different
    displacement groups of the kernel, so the tie crosses its final
    merge."""
    import torch
    from vvc_torch import ops
    from vvc_torch.enc import me
    rng = np.random.default_rng(h + w)
    for kind in ("noise", "flat", "tie"):
        if kind == "tie":
            base = np.full((h, w), 300)
            base[:, np.isin(np.arange(w) % 32, (0, 1, 2, 3, 12, 13, 14, 15,
                                               20, 21, 22, 23, 24, 25, 26,
                                               27))] += 40
            pics = [np.full((h, w), 300), base, base]
        else:
            pics = [np.full((h, w), 300) if kind == "flat"
                    else rng.integers(0, 1024, (h, w)) for _ in range(3)]
        planes = [torch.from_numpy(p.astype(np.int32)).to(dev)
                  for p in pics]
        before = ops.COUNTS["me_prep"]
        preps = [_both(me.prep_ref, p) for p in planes]
        assert ops.COUNTS["me_prep"] == before + 3
        for got, want in preps:
            assert torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                                want[1])
        yds = preps[0][0][1]
        refds = torch.stack([p[0][1] for p in preps[1:]])
        got, want = _both(me.coarse_search, yds, refds)
        for s in (16, 32, 64):
            assert torch.equal(got[s], want[s])


@pytest.mark.parametrize("bit_depth", (8, 10))
@pytest.mark.parametrize("size", (8, 16, 32, 64))
def test_me_int_qpel_equal_plain(dev, size, bit_depth):
    """me_int and me_qpel against their twins at every size: a shifted
    textured picture, a flat one (constructed ties) and, at 10 bit,
    noise (SSE sums above 2^24); costs bit for bit."""
    import torch
    from vvc_torch.enc import me
    from vvc_torch.enc.rdo import lambda_f32
    rng = np.random.default_rng(size * bit_depth)
    h, w = 128, 192
    mx = (1 << bit_depth) - 1
    yy, xx = np.mgrid[0:h + 8, 0:w + 8]
    tex = np.clip(mx * (0.5 + 0.3 * np.sin(xx / 5.0) * np.cos(yy / 7.0))
                  + rng.integers(-3, 4, xx.shape), 0, mx)
    cases = [(tex[2:2 + h, 5:5 + w], tex[6:6 + h, 1:1 + w]),
             (np.full((h, w), mx // 2), np.full((h, w), mx // 2))]
    if bit_depth == 10:
        cases.append((rng.integers(0, mx + 1, (h, w)),
                      rng.integers(0, mx + 1, (h, w))))
    _, lam_m = lambda_f32(32)
    for ref, cur in cases:
        rp = me.prep_ref(torch.from_numpy(ref.astype(np.int32)).to(dev))[0]
        ny, nx = h // size, w // size
        cur_t = torch.from_numpy(cur.astype(np.int32)).to(dev)
        ob = (cur_t.reshape(ny, size, nx, size).permute(0, 2, 1, 3)
              .reshape(-1, size, size).contiguous())
        ys = (torch.arange(ny, dtype=torch.int32, device=dev) * size
              ).repeat_interleave(nx)
        xs = (torch.arange(nx, dtype=torch.int32, device=dev) * size
              ).repeat(ny)
        cy = torch.from_numpy(rng.integers(-36, 37, ny * nx).astype(
            np.int32)).to(dev)
        cx = torch.from_numpy(rng.integers(-36, 37, ny * nx).astype(
            np.int32)).to(dev)
        cy[::3] = 0
        cx[::3] = 0
        got, want = _both(me.int_refine, rp, ob, ys, xs, cy, cx, lam_m,
                          size, h, w)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        got, want = _both(me.qpel_refine, rp, ob, ys, xs, got[0], got[1],
                          lam_m, size, bit_depth)
        _assert_qpel_equal(got, want)
    # me_qpel alone: N = 0, 1 and 7 (not a multiple of the 4 blocks a CTA
    # takes at size 8); the windows of the first blocks on the four edges
    # of the padded reference, the others anywhere; and a flat picture
    # with lam_m = 0, where all 49 costs tie (the first, qy = qx = -3,
    # must win)
    for ref, cur, lam in ((tex[:h, :w], tex[4:4 + h, 3:3 + w], lam_m),
                          (np.full((h, w), mx // 3), np.full((h, w), mx // 3),
                           0.0)):
        rp = me.prep_ref(torch.from_numpy(ref.astype(np.int32)).to(dev))[0]
        hp, wp = rp.shape
        for n in (0, 1, 7):
            ys = rng.integers(0, h - size + 1, n)
            xs = rng.integers(0, w - size + 1, n)
            # the window's origin in the padded reference is ys + iy + 10
            iy = rng.integers(-(ys + 10), hp - size - 22 - ys + 1)
            ix = rng.integers(-(xs + 10), wp - size - 22 - xs + 1)
            for i, (ey, ex) in enumerate(((0, 0), (1, 1), (0, 1), (1, 0))):
                if i < n:
                    iy[i] = -(ys[i] + 10) if ey == 0 else hp - size - 22 - ys[i]
                    ix[i] = -(xs[i] + 10) if ex == 0 else wp - size - 22 - xs[i]
            ob = np.stack([cur[y:y + size, x:x + size] for y, x in zip(ys, xs)]
                          ) if n else np.zeros((0, size, size))
            args = [torch.from_numpy(a.astype(np.int32)).to(dev)
                    for a in (ob, ys, xs, iy, ix)]
            got, want = _both(me.qpel_refine, rp, *args, lam, size, bit_depth)
            _assert_qpel_equal(got, want)
            assert got[3].shape == (n, size, size)
            if lam == 0.0 and n:
                assert torch.equal(got[0], 4 * args[3] - 3)
                assert torch.equal(got[1], 4 * args[4] - 3)


def _assert_qpel_equal(got, want):
    import torch
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(got[2].view(torch.int32), want[2].view(torch.int32))
    assert torch.equal(got[3], want[3])


@pytest.mark.parametrize("mode,n", [("ldp", 3), ("ldb", 3), ("ra", 5)])
def test_inter_stream_equal_plain(dev, mode, n):
    """Small LDP / LDB / RA encodes on the motion clip: the kernel path's
    stream equals the plain path's, and every ME kernel launched."""
    from vvc_torch import ops
    from vvc_torch.enc.encoder import encode_sequence
    from vvc_torch.io.synth import motion_clip
    clip = motion_clip(n, 128, 64)
    before = dict(ops.COUNTS)
    kw = {"gop_size": 4} if mode == "ra" else {}
    a = encode_sequence(clip, qp=32, mode=mode, **kw)[0]
    assert all(ops.COUNTS[k] > before[k]
               for k in ("me_prep", "me_coarse", "me_int", "me_qpel"))
    with ops.plain():
        b = encode_sequence(clip, qp=32, mode=mode, **kw)[0]
    assert a == b


# ---------------------------------------------------------------------------
# Slice 2c: the rect kernels (MTT lattice, ISP sub-TUs)
# ---------------------------------------------------------------------------

RECT = ((64, 32), (32, 64), (64, 16), (16, 64), (32, 16), (16, 32), (32, 8),
        (8, 32), (16, 8), (8, 16))
ISP_RECT = ((8, 4), (16, 4), (32, 4), (4, 8), (4, 16), (4, 32), (16, 8),
            (32, 8), (8, 16), (8, 32))


@pytest.mark.parametrize("bit_depth", (8, 10))
def test_rect_prediction_kernels_equal_plain(dev, bit_depth):
    """ref_lines_rect at every rect lattice and ISP shape (grid and random
    positions, frame edges included), intra_pred_all_rect at the ten rect
    shapes, intra_pred_one_rect at the ISP shapes for every mode, the
    wide-angle ones and out-of-range modes."""
    import torch
    from vvc_torch import ops
    from vvc_torch.enc import rdo
    from vvc_torch.kernels import intra
    rng = np.random.default_rng(40 + bit_depth)
    ph, pw = 96, 160
    plane = torch.from_numpy(rng.integers(0, 1 << bit_depth, (ph, pw))
                             .astype(np.int32)).to(dev)
    before = dict(ops.COUNTS)
    shapes = sorted(set(RECT) | set(ISP_RECT))
    for w, h in shapes:
        xs = torch.from_numpy(rng.integers(0, pw, 64).astype(np.int32)).to(dev)
        ys = torch.from_numpy(rng.integers(0, ph, 64).astype(np.int32)).to(dev)
        xs[:8] = 0
        ys[4:12] = 0
        refs, want = _both(rdo.build_ref_lines_device_rect, plane, xs, ys, w,
                           h, bit_depth)
        assert torch.equal(refs, want), (w, h)
        if (w, h) in RECT:
            got, want = _both(intra.predict_all_modes_batch_rect, refs, w, h,
                              bit_depth)
            assert torch.equal(got, want), (w, h)
        if (w, h) in ISP_RECT:
            modes = np.concatenate([np.arange(67), rng.integers(0, 67, 61),
                                    [-2, 67, 80]]).astype(np.int32)
            r2 = torch.from_numpy(rng.integers(0, 1 << bit_depth, (
                len(modes), 2 * h + 2 * w + 3)).astype(np.int32)).to(dev)
            r2[:10] = r2[:10, :1]
            got, want = _both(intra.predict_modes_batch_rect, r2,
                              torch.from_numpy(modes).to(dev), w, h,
                              bit_depth)
            assert torch.equal(got, want), (w, h)
    assert ops.COUNTS["ref_lines_rect"] == before["ref_lines_rect"] + len(
        shapes)
    assert ops.COUNTS["intra_pred_all_rect"] == before[
        "intra_pred_all_rect"] + len(RECT)
    assert ops.COUNTS["intra_pred_one_rect"] == before[
        "intra_pred_one_rect"] + len(ISP_RECT)
    assert ops.COUNTS["ref_lines"] == before["ref_lines"]


@pytest.mark.parametrize("bit_depth", (8, 10))
def test_rect_transform_quant_equal_plain(dev, bit_depth):
    """transform_fwd → quant_rate (intra and inter dead zone) →
    transform_inv at every rect and 4-point shape of the path with its
    transform pairs (MTS where both sides are 8..32, ISP's implicit pair,
    DCT2 with a 64-point side); the rates bit for bit."""
    import torch
    from vvc_torch.kernels import quant, transform
    from vvc_torch.kernels.isp import isp_tr_types
    rng = np.random.default_rng(50 + bit_depth)
    lim = 1 << bit_depth
    for w, h in sorted(set(RECT) | set(ISP_RECT) | {(8, 8)}):
        pairs = {isp_tr_types(w, h), (0, 0)}
        if 8 <= w <= 32 and 8 <= h <= 32:
            pairs |= set(transform.MTS_TR)
        resi = torch.from_numpy(rng.integers(-lim + 1, lim, (200, h, w))
                                .astype(np.int32)).to(dev)
        for th, tv in sorted(pairs):
            coeff, want = _both(transform.fwd_transform_batch, resi,
                                bit_depth, th, tv)
            assert torch.equal(coeff, want), (w, h, th, tv)
            for qp in (0, 22, 37, 63):
                for intra_dz in (False, True):
                    got, want = _both(quant.quant_rate, coeff, qp, bit_depth,
                                      False, intra_dz)
                    assert torch.equal(got[0].view(torch.int32),
                                       want[0].view(torch.int32)), (w, h)
                    assert torch.equal(got[1], want[1]), (w, h)
            rec, want = _both(transform.inv_transform_batch, got[1],
                              bit_depth, th, tv)
            assert torch.equal(rec, want), (w, h, th, tv)


@pytest.mark.parametrize("cols", (1, 2))
def test_mtt_isp_search_vector_equal_plain(dev, cols):
    """The MTT + ISP search (LFNST and the chroma decision on) at 416×240,
    one frame or two tile columns: kernels == plain, and every kernel of
    the intra search launched, the rect ones included."""
    import torch
    from vvc_torch import ops
    from vvc_torch.enc import rdo
    from vvc_torch.io.synth import synth_frame
    w, h = 416 // cols, 240
    shapes = rdo._candidate_shapes(64, 8, True)
    f = synth_frame(416, h, 3)
    cut = lambda p, k: np.stack([p[:, i * k:(i + 1) * k] for i in range(cols)])
    vec = torch.from_numpy(rdo.pack_planes(cut(f.y, w), cut(f.cb, w // 2),
                                           cut(f.cr, w // 2))).to(dev)
    ops.reset_counts()
    got, want = _both(rdo.eval_all_sizes_frames, vec, shapes, 32, 8, w, h,
                      cols, False, True, True, True)
    assert torch.equal(got, want)
    assert all(ops.COUNTS[k] > 0 for k in ops.COUNTS
               if k not in ("sao_stats", "alf_stats", "me_prep",
                            "me_coarse", "me_int", "me_qpel") + KERNELS_4B
               + KERNELS_DEC + KERNELS_SHARD + KERNELS_R4)


def test_mtt_isp_mrl_dq_stream_equal_plain(dev):
    """encode_sequence with mtt, isp, mrl and dep_quant at 416×240, 2
    frames, single tile and 2 tile columns: kernel stream == plain."""
    from vvc_torch import ops
    from vvc_torch.enc.encoder import encode_sequence
    from vvc_torch.io.synth import synth_frame
    frames = [synth_frame(416, 240, t) for t in range(2)]
    kw = dict(qp=32, mtt=True, isp=True, mrl=True, dep_quant=True)
    for cols in (1, 2):
        got = encode_sequence(frames, num_tile_cols=cols, **kw)[0]
        with ops.plain():
            want = encode_sequence(frames, num_tile_cols=cols, **kw)[0]
        assert got == want, cols


# ---------------------------------------------------------------------------
# Slice 4b: the affine search, its DCTIF prediction, MCTF's block error
# ---------------------------------------------------------------------------

def _affine_inputs(dev, s, bit_depth, n, seed, content):
    """Padded reference, blocks, origins, integer winners and quarter-pel
    seeds for the affine search (windows inside the padded plane)."""
    import torch
    rng = np.random.default_rng(seed)
    mx = (1 << bit_depth) - 1
    H = W = 4 * s
    if content == "noise":
        refpad = rng.integers(0, mx + 1, (H + 32, W + 32))
        ob = rng.integers(0, mx + 1, (n, s, s))
    else:       # near-flat: small costs, ties and rounding-sensitive sums
        refpad = mx // 3 + rng.integers(0, 2, (H + 32, W + 32))
        ob = mx // 3 + rng.integers(0, 2, (n, s, s))
    ys = rng.integers(0, H - s + 1, n)
    xs = rng.integers(0, W - s + 1, n)
    iy = np.clip(rng.integers(-4, 5, n), -(ys + 10), H + 10 - s - ys)
    ix = np.clip(rng.integers(-4, 5, n), -(xs + 10), W + 10 - s - xs)
    mvy0 = 4 * iy + rng.integers(-3, 4, n)
    mvx0 = 4 * ix + rng.integers(-3, 4, n)
    return [torch.from_numpy(np.ascontiguousarray(a).astype(np.int32)).to(dev)
            for a in (refpad, ob, ys, xs, mvy0, mvx0, iy, ix)]


@pytest.mark.parametrize("bit_depth", (8, 10))
@pytest.mark.parametrize("size", (16, 32, 64))
def test_affine_kernels_equal_plain(dev, size, bit_depth):
    """affine_search (+ affine_dctif for the winner's prediction) against
    its twin on noise and near-flat blocks at λ of QP 21, 29 and 37 (costs
    bit for bit), and affine_dctif alone at every (qy, qx) in [−12, 11]²."""
    import torch
    from vvc_torch import ops
    from vvc_torch.enc import me
    from vvc_torch.enc.rdo import lambda_f32
    for content in ("noise", "flat"):
        args = _affine_inputs(dev, size, bit_depth, 96, size + bit_depth,
                              content)
        for qp in (21, 29, 37):
            before = ops.COUNTS["affine_search"]
            got, want = _both(me.affine_search, *args, lambda_f32(qp)[1],
                              size, bit_depth)
            assert ops.COUNTS["affine_search"] == before + 1
            assert torch.equal(got[0].view(torch.int32),
                               want[0].view(torch.int32))
            for a, b in zip(got[1:], want[1:]):
                assert torch.equal(a, b)
    refpad, _, ys, xs, _, _, iy, ix = _affine_inputs(
        dev, size, bit_depth, 576 // (size // 4) ** 2 + 1, 7, "noise")
    n, nsb = ys.shape[0], size // 4
    q = torch.arange(n * nsb * nsb, device=dev, dtype=torch.int32) % 576
    qy = (q // 24 - 12).reshape(n, nsb, nsb).contiguous()
    qx = (q % 24 - 12).reshape(n, nsb, nsb).contiguous()
    got, want = _both(me.affine_dctif_pred, refpad, ys, xs, iy, ix, qy, qx,
                      size, bit_depth)
    assert torch.equal(got, want)


@pytest.mark.parametrize("bit_depth", (8, 10))
def test_me_block_err_equal_plain(dev, bit_depth):
    """me_block_err and the whole me_pred_v2 against the plain path at
    240×416 (10-bit noise: block sums above 2^24); err bit for bit."""
    import torch
    from vvc_torch import ops
    from vvc_torch.enc import me
    rng = np.random.default_rng(bit_depth)
    h, w = 240, 416
    mx = (1 << bit_depth) - 1
    ref = torch.from_numpy(rng.integers(0, mx + 1, (h, w)).astype(
        np.int32)).to(dev)
    cur = torch.from_numpy(rng.integers(0, mx + 1, (h, w)).astype(
        np.int32)).to(dev)
    pred = torch.from_numpy(rng.integers(0, mx + 1, ((h // 16) * (w // 16),
                                                     16, 16)).astype(
        np.int32)).to(dev)
    got, want = _both(me.block_err, pred, cur, h // 16, w // 16)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))
    rp, rds = me.prep_ref(ref)
    cds = me.prep_ref(cur)[1]
    coarse = me.coarse_search(cds, rds[None])[16][0]
    before = ops.COUNTS["me_block_err"]
    got, want = _both(me.me_pred_v2, cur, rp, coarse, w, h, bit_depth,
                      np.float32(3.7))
    assert ops.COUNTS["me_block_err"] == before + 1
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))


def test_4b_stream_equal_plain(dev):
    """RA GOP 4 with every slice-4b option on the tool clip: the kernel
    path's stream equals the plain path's, and the three 4b kernels
    launched."""
    from chip_smoke import tool_clip
    from vvc_torch import ops
    from vvc_torch.enc.encoder import encode_sequence
    from vvc_torch.io.yuv import Frame
    w, h = 192, 128
    c = np.full((h // 2, w // 2), 128, np.int32)
    clip = [Frame(y, c, c.copy(), 8) for y in tool_clip(5, w, h)]
    kw = dict(qp=32, mode="ra", gop_size=4, affine=True, mctf=True,
              bdof=True, dmvr=True, mmvd=True, ciip=True, gpm=True,
              amvr=True, smvd=True, bcw=True)
    before = dict(ops.COUNTS)
    a = encode_sequence(clip, **kw)[0]
    assert all(ops.COUNTS[k] > before[k]
               for k in ("affine_search", "affine_dctif", "me_block_err"))
    with ops.plain():
        b = encode_sequence(clip, **kw)[0]
    assert a == b


# ---------------------------------------------------------------------------
# Slice 5: the decoder's wavefront kernels
# ---------------------------------------------------------------------------


def _order_map(rng, h, w, tile_x=None):
    """z-order indices with the rows below a cut pending, some units
    pending at random and, with tile_x, the columns left of it another
    tile's."""
    big = np.iinfo(np.int32).max
    order = rng.integers(0, 200, size=((h + 3) >> 2, (w + 3) >> 2)
                         ).astype(np.int32)
    order[int(rng.integers(1, order.shape[0])):, :] = big
    order[rng.random(order.shape) < 0.1] = big
    if tile_x is not None:
        order[:, :tile_x >> 2] = big
    return order


@pytest.mark.parametrize("bit_depth", (8, 10))
@pytest.mark.parametrize("s", (4, 8, 16, 32, 64))
def test_wave_kernels_equal_plain(dev, s, bit_depth):
    """wave_ref_lines, dequant, wave_cclm (chroma sizes) and wave_commit
    (BDPCM included) against their plain versions, each launched once."""
    import torch
    from vvc_torch import ops
    from vvc_torch.dec.wavefront import commit_wave
    from vvc_torch.kernels.cclm import predict_cclm_wave
    from vvc_torch.kernels.intra import build_ref_lines_wave
    from vvc_torch.kernels.quant import dequant_batch
    rng = np.random.default_rng(10 * s + bit_depth)
    h, w = 3 * s + 12, 4 * s + 20
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)
    plane = t(rng.integers(0, 1 << bit_depth, size=(h, w)))
    order = t(_order_map(rng, h, w, 2 * s))
    n = 40
    xs = t(rng.integers(0, w - s + 1, n) & ~3)
    ys = t(rng.integers(0, h - s + 1, n) & ~3)
    zis = t(rng.integers(0, 260, n))
    before = dict(ops.COUNTS)
    got, want = _both(build_ref_lines_wave, plane, order, xs, ys, zis, s,
                      bit_depth)
    assert torch.equal(got, want)
    lv = t(rng.integers(-300, 301, size=(n, s, s)))
    got, want = _both(dequant_batch, lv, 37, bit_depth)
    assert torch.equal(got, want)
    if s <= 32:
        var = t(rng.integers(0, 4, n))
        pred0 = t(rng.integers(0, 9, size=(n, s, s)))
        got, want = _both(lambda: predict_cclm_wave(
            plane, plane.flip(0).contiguous(), order, xs, ys, zis, var, s,
            bit_depth, pred0.clone()))
        assert torch.equal(got, want)
    # one leaf per cell of an s-grid: the leaves of a wave never overlap
    gy, gx = np.divmod(np.arange(6), 3)
    cx, cy, cz = t(gx * s), t(gy * s), t(np.arange(6) + 40)
    bd = t(np.array([0, 1, 2, 0, 1, 2]))
    pred = t(rng.integers(0, 1 << bit_depth, size=(6, s, s)))
    resi = t(rng.integers(-64, 65, size=(6, s, s)))
    outs = []
    for plain in (False, True):
        p, o = plane.clone(), order.clone()
        if plain:
            with ops.plain():
                commit_wave(p, o, pred, resi, cx, cy, cz, bd, bit_depth)
        else:
            commit_wave(p, o, pred, resi, cx, cy, cz, bd, bit_depth)
        torch.cuda.synchronize()
        outs.append((p, o))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    for k in KERNELS_DEC:
        want_n = 0 if (k == "wave_cclm" and s == 64) else 1
        assert ops.COUNTS[k] == before[k] + want_n, k


@pytest.mark.parametrize("kw", [{}, {"lossless": True},
                                {"num_tile_cols": 2}])
def test_wavefront_decode_equal_plain(dev, kw):
    """A port-encoded 416×240 AI stream (lossy, lossless, 2 tile columns)
    decodes through the wavefront kernels to the plain path's frames and
    the encoder's recons, every hash OK, each decoder kernel launched."""
    from vvc_torch import ops
    from vvc_torch.dec.decoder import decode_stream
    from vvc_torch.enc.encoder import encode_sequence
    from vvc_torch.io.synth import synth_frame
    frames = [synth_frame(416, 240, t) for t in range(2)]
    bs, recons, _ = encode_sequence(frames, qp=32, **kw)
    ops.reset_counts()
    got, info = decode_stream(bs, wavefront=True)
    assert all(info["hash_ok"]) and len(info["hash_ok"]) == 2
    want_k = {"wave_ref_lines", "wave_commit"} | (
        set() if kw.get("lossless") else {"dequant", "wave_cclm"})
    assert all(ops.COUNTS[k] > 0 for k in want_k)
    with ops.plain():
        want, _ = decode_stream(bs, wavefront=True)
    host, _ = decode_stream(bs)
    for g, w_, h_, r in zip(got, want, host, recons):
        for a, b, c, d in zip(g.planes(), w_.planes(), h_.planes(),
                              r.planes()):
            assert (a == b).all() and (a == c).all() and (a == d).all()



@pytest.mark.parametrize("bit_depth", (8, 10))
def test_tile_edge_deblock_equal_plain(dev, bit_depth):
    """tile_edge_deblock against deblock_stripe_plain on 1080-row stripes
    (smooth sides with steps, and noise; halos that continue the stripe
    with a small step), both edges, one edge and none, at QP 12 (tC = 0:
    nothing changes), 22, 32, 37 and 51; one launch a call."""
    import torch
    from vvc_torch import ops
    from vvc_torch.shard.filter import deblock_stripe, edge_params
    rng = np.random.default_rng(bit_depth)
    s = 1 << (bit_depth - 8)
    h, wt = 1080, 960
    base = (100 * s + np.arange(wt)[None, :] // 16
            + rng.integers(0, 12 * s, (h // 4, 1)).repeat(4, 0))
    noise = rng.integers(0, 4 * s, (h, wt)) * (
        rng.random((h // 4, 1)) < 0.4).repeat(4, 0)
    xs = (base + noise).astype(np.int32)
    x = torch.from_numpy(xs).to(dev)
    # the neighbours continue the stripe with a small step: edges filter
    fl = torch.from_numpy(xs[:, :4] - 3 * s).to(dev)
    fr = torch.from_numpy(xs[:, -4:] + 2 * s).to(dev)
    for qp in (12, 22, 32, 37, 51):
        beta, tc, maxv = edge_params(qp, bit_depth)
        for left, right in ((True, True), (True, False), (False, True),
                            (False, False)):
            before = ops.COUNTS["tile_edge_deblock"]
            got, want = _both(deblock_stripe, x, fl, fr, left, right, beta,
                              tc, maxv)
            assert torch.equal(got, want), (qp, left, right)
            assert ops.COUNTS["tile_edge_deblock"] == before + 1
            assert torch.equal(got[:, 4:-4], x[:, 4:-4])
            if left and right:
                changed = bool((got != x).any())
        assert changed == (tc > 0)


# ---------------------------------------------------------------------------
# Slice 7: the r4 engine, the Gauss-Newton affine ME, SSE/SAD
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bit_depth", (8, 10))
def test_interp_gather_block_dist_equal_plain(dev, bit_depth):
    """interp_planes, phase_gather (negative MVs, border clamps) and
    block_dist (SSE bit for bit, sums past 2^24 at 10 bit; SAD) against
    their plain versions; one launch each per call."""
    import torch
    from vvc_torch import ops
    from vvc_torch.kernels import mc, satd
    rng = np.random.default_rng(bit_depth)
    mx = (1 << bit_depth) - 1
    plane = torch.from_numpy(rng.integers(0, mx + 1, (70, 136)).astype(
        np.int32)).to(dev)
    before = dict(ops.COUNTS)
    planes, want = _both(mc.interp_luma_planes, plane, bit_depth)
    assert torch.equal(planes, want)
    for s in (8, 16, 64):
        n = 200
        xs = torch.from_numpy(rng.integers(0, 136 - s, n).astype(
            np.int32)).to(dev)
        ys = torch.from_numpy(rng.integers(0, 70 - s, n).astype(
            np.int32)).to(dev)
        mvx = torch.from_numpy(rng.integers(-300, 300, n).astype(
            np.int32)).to(dev)
        mvy = torch.from_numpy(rng.integers(-300, 300, n).astype(
            np.int32)).to(dev)
        pred, want = _both(mc.gather_pred_planes, planes, xs, ys, mvx, mvy,
                           s)
        assert torch.equal(pred, want)
        orig = torch.from_numpy((rng.integers(0, 2, (n, s, s)) * mx).astype(
            np.int32)).to(dev)
        got, want = _both(satd.sse_batch, pred, orig)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        got, want = _both(satd.sad_batch, pred, orig)
        assert torch.equal(got, want)
    assert ops.COUNTS["interp_planes"] == before["interp_planes"] + 1
    assert ops.COUNTS["phase_gather"] == before["phase_gather"] + 3
    assert ops.COUNTS["block_dist"] == before["block_dist"] + 6


@pytest.mark.parametrize("bit_depth", (8, 10))
def test_me_full_and_r4_program_equal_plain(dev, bit_depth):
    """me_full from centre 0 and from random centres, and the whole
    me_pred_program (me_full, phase_gather, satd, block_dist) on a
    motion_clip pair: kernels == plain, plane and err bit for bit."""
    import torch
    from vvc_torch import ops
    from vvc_torch.enc import inter_search
    from vvc_torch.io.synth import motion_clip
    from vvc_torch.kernels import mc
    h, w = 128, 192
    clip = motion_clip(2, w, h, bit_depth=bit_depth)
    cur = torch.from_numpy(clip[1].y.astype(np.int32)).to(dev)
    ref = torch.from_numpy(clip[0].y.astype(np.int32)).to(dev)
    lam = np.float32(np.sqrt(0.57 * 2 ** ((32 - 12) / 3)))
    phase = mc.interp_luma_planes(ref, bit_depth)
    before = dict(ops.COUNTS)
    got, want = _both(inter_search.me_pred_program, cur, phase, 16, 8, w, h,
                      lam)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))
    assert all(ops.COUNTS[k] > before[k]
               for k in ("me_full", "phase_gather", "satd", "block_dist"))
    rng = np.random.default_rng(bit_depth)
    n = (h // 32) * (w // 32)
    blocks = torch.from_numpy(rng.integers(0, 1 << bit_depth, (n, 32, 32))
                              .astype(np.int32)).to(dev)
    xs = torch.arange(n, dtype=torch.int32, device=dev) % (w // 32) * 32
    ys = torch.arange(n, dtype=torch.int32, device=dev) // (w // 32) * 32
    c = torch.from_numpy(rng.integers(-9, 10, (2, n)).astype(np.int32)).to(
        dev)
    got, want = _both(inter_search.int_me, blocks, ref, xs, ys, 32, 12, lam,
                      c[0], c[1])
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("n_params", (4, 6))
@pytest.mark.parametrize("size", (16, 64))
def test_affine_gn_equal_plain(dev, size, n_params):
    """affine_gn against its plain twin (the same float32 order): the
    corner MVs equal, one launch a call."""
    import torch
    from vvc_torch import ops
    from vvc_torch.kernels import affine
    rng = np.random.default_rng(size + n_params)
    base = rng.integers(0, 256, (160, 224)).astype(np.float64)
    for _ in range(3):
        base = (np.roll(base, 1, 0) + base + np.roll(base, -1, 0)) / 3
        base = (np.roll(base, 1, 1) + base + np.roll(base, -1, 1)) / 3
    ref = torch.from_numpy(base.round().astype(np.float32)).to(dev)
    ny, nx = 160 // size, 224 // size
    cur = torch.roll(ref, (1, -2), (0, 1))
    blocks = (cur[:ny * size, :nx * size].reshape(ny, size, nx, size)
              .permute(0, 2, 1, 3).reshape(-1, size, size).contiguous())
    n = ny * nx
    xs = torch.arange(n, dtype=torch.int32, device=dev) % nx * size
    ys = torch.arange(n, dtype=torch.int32, device=dev) // nx * size
    m0 = torch.from_numpy(rng.integers(-6, 7, (2, n)).astype(np.int32)).to(
        dev)
    before = ops.COUNTS["affine_gn"]
    got, want = _both(affine.affine_me_batch, blocks, ref, xs, ys, m0[0],
                      m0[1], size, 8, n_params)
    assert torch.equal(got, want)
    assert ops.COUNTS["affine_gn"] == before + 1

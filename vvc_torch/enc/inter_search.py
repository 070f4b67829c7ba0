"""Batched inter search: window motion estimation + mode decision.

Port of vvc/enc/inter_search.py (reference: InterSearch.cpp →
predInterSearch / xMotionEstimation; EncCu.cpp → xCheckRDCostInter), the
translational part that vvc's default tool set runs for every P and B
picture (`rdo_inter_partition`):

  * Program (1), the intra search of every candidate size, is the ported
    single-frame `eval_all_sizes` (luma only), as in vvc.
  * Program (2): the references' padded and ds4 planes (`me.pic_dev`,
    kernel `me_prep`, cached per picture), one coarse full search over all
    of them (`me.coarse_search`, kernel `me_coarse`), then per size class
    64, 32 and 16 `me_v2_program`: per (list, ref) the integer window
    refine (kernel `me_int`) and the quarter-pel refine (kernel `me_qpel`)
    of every block, the running minimum over refs (`_run_min`), and
    `_finish`: list choice, the bi average checked by SATD (kernel
    `satd`), the MVD bits and the DCT2 RD cost (`_inter_rd`: kernels
    `transform_fwd`, `quant_rate` with the inter dead zone,
    `transform_inv`).  The 8×8 children ride the 16×16 program: each
    evaluates its parent's window with the parent's centre.
  * One packed float32 vector per size comes back; the host unpack and
    the DP (`_dp_backtrack_inter`, copied unchanged) pick split, intra or
    inter per node.

The packed vectors are bit-equal to vvc's on XLA-CPU (jax 0.9.0): λ and √λ
are float32 bit tables (vvc_torch.enc.rdo), the MVD bits are
(log2(1+|Δx|) + log2(1+|Δy|)) + 6 with XLA's float32 `log` and its
contraction fma(log(1+|Δx|), 1/ln 2, log(1+|Δy|)·(1/ln 2)), and the RD
cost is fma(λ, rate + bits, sse) with the rate summed in XLA's order
(`quant_rate`).

With affine on, each size 16, 32 and 64 also runs the affine search of
reference 0 of each list (`me.affine_search`, kernels `affine_search` and
`affine_dctif`) around the translational winner, and `_finish` keeps the
affine candidate where its DCT2 RD cost is lower (the corner points in the
packed `cp0`/`cp1` fields).

vvc's DP looks the intra costs up by int size in a dict keyed by (w, h)
shapes, so it never finds them: every leaf of an inter picture is inter,
and program (1) is computed and not read.  The port reproduces this.

The r4 engine (vvc's MCTF before the window search replaced it) is here
too: `me_pred_program` — the integer full search `int_me` (CUDA kernel
`me_full`), the half- then quarter-pel refine `frac_refine` over phase
planes (kernels `phase_gather` and `satd`) and the prediction plane with
its per-block error (kernel `block_dist`).
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from vvc_torch.enc import me as me_mod
from vvc_torch.enc.rdo import (SPLIT_BITS, _candidate_sizes, _fma_f32,
                               _sse_f32, eval_all_sizes, lambda_f32,
                               pack_planes, rd_lambda, unpack_results)
from vvc_torch import ops
from vvc_torch.kernels.mc import gather_pred_planes
from vvc_torch.kernels.quant import quant_rate
from vvc_torch.kernels.satd import satd_batch, sse_batch
from vvc_torch.kernels.transform import (fwd_transform_batch,
                                         inv_transform_batch)
from vvc_torch.model.frame import Leaf
from vvc_torch.model.partition import SPLIT_NONE, SPLIT_QT
from vvc_torch.ops import resolve_device
from vvc_torch.rom.log_table import xla_log_f32

ME_SIZES_MIN = 8       # integer ME at sizes >= this (8×8 searches a small
                       # window centered on the parent 16×16 MV)

# float32 bits of 1/ln 2: XLA folds log2(x) = log(x)·(1/ln 2)
_INV_LN2 = np.array([0x3FB8AA3B], dtype=np.uint32).view(np.float32)[0]

@lru_cache(maxsize=None)
def _log_dev(device: str) -> torch.Tensor:
    return torch.from_numpy(xla_log_f32().copy()).to(device)


def _log2_sum(dx: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """log2(1 + |Δx|) + log2(1 + |Δy|) in float32 as XLA-CPU computes it:
    fma(log(1+|Δx|), 1/ln 2, log(1+|Δy|)·(1/ln 2)), XLA's float32 log."""
    tab = _log_dev(str(dx.device))
    lx, ly = tab[dx.abs().long()], tab[dy.abs().long()]
    return _fma_f32(_INV_LN2, lx, ly * _INV_LN2)


def _affine_bits(l2: torch.Tensor, dcp: torch.Tensor) -> torch.Tensor:
    """vvc's `acpb = mvb + 6 + log2(1 + dcp_x) + log2(1 + dcp_y)` as XLA
    computes it (optimised HLO, jax 0.9.0): it folds mvb's + 6 and the + 6
    into + 12 on the log sum l2 (`_log2_sum`), and the backend contracts each
    log2 term into an FMA: fma(log(1+dcp_y), 1/ln 2, fma(log(1+dcp_x),
    1/ln 2, l2 + 12))."""
    tab = _log_dev(str(dcp.device))
    t = l2 + np.float32(12.0)
    t = _fma_f32(_INV_LN2, tab[dcp[:, 0].long()], t)
    return _fma_f32(_INV_LN2, tab[dcp[:, 1].long()], t)


def _inter_rd(orig, pred, qp: int, bit_depth: int, extra_bits):
    """vvc/enc/inter_search.py:156 `_inter_rd_dev`: DCT2 RD cost of coding
    orig over the inter prediction → [N] float32,
    fma(λ, rate + extra_bits, sse) with the inter dead zone."""
    lam, _ = lambda_f32(qp)
    resi = orig - pred
    coeff = fwd_transform_batch(resi, bit_depth, 0, 0)
    rate, deq = quant_rate(coeff, qp, bit_depth, intra=False)
    rec_resi = inv_transform_batch(deq, bit_depth, 0, 0)
    rec = (pred + rec_resi).clamp(0, (1 << bit_depth) - 1)
    sse = _sse_f32(rec - orig)
    return _fma_f32(lam, rate + extra_bits, sse)


def _reorder_children(f, nye: int, nxe: int, ny8: int, nx8: int):
    """Child field [4·N16e, …] (parent-major, sub (0,0),(0,1),(1,0),(1,1))
    → raster [ny8·nx8, …]."""
    tail = tuple(f.shape[1:])
    g = f.reshape((nye, nxe, 2, 2) + tail)
    perm = (0, 2, 1, 3) + tuple(range(4, 4 + len(tail)))
    g = g.permute(perm).reshape((2 * nye, 2 * nxe) + tail)
    return g[:ny8, :nx8].reshape((-1,) + tail)


def _run_min(best, ent):
    m = ent["cost"] < best["cost"]
    mm = m[:, None, None]
    return dict(mvy=torch.where(m, ent["mvy"], best["mvy"]),
                mvx=torch.where(m, ent["mvx"], best["mvx"]),
                cost=torch.where(m, ent["cost"], best["cost"]),
                pred=torch.where(mm, ent["pred"], best["pred"]),
                ref=torch.where(m, ent["ref"], best["ref"]))


def _finish(l0, l1, ob, qp: int, bit_depth: int, lam_m, ny: int, nx: int,
            is_b: bool, affine_res=None):
    """vvc/enc/inter_search.py:183 `_finish`: per-block list selection, bi
    check, RD, the affine RD where `affine_res` is a per-list list of (cost,
    cp [N, 3, 2] (x, y), pred), and the packed float32 fields."""
    n = ob.shape[0]
    dev = ob.device
    zero = torch.zeros(n, dtype=torch.int32, device=dev)
    dirs = torch.ones(n, dtype=torch.int32, device=dev)
    if is_b and l1 is not None:
        dirs = torch.where(l1["cost"] < l0["cost"], 2, 1).to(torch.int32)
        pbi = (l0["pred"] + l1["pred"] + 1) >> 1
        # satd + √λ·8: the product is exact, so one rounding either way
        cbi = _fma_f32(lam_m, torch.full((n,), 8.0, device=dev),
                             satd_batch(pbi, ob).to(torch.float32))
        cuni = torch.where(dirs == 2, l1["cost"], l0["cost"])
        dirs = torch.where(cbi < cuni, 3, dirs).to(torch.int32)
        pred = torch.where((dirs == 3)[:, None, None], pbi,
                           torch.where((dirs == 2)[:, None, None],
                                       l1["pred"], l0["pred"]))
    else:
        l1 = dict(mvy=zero, mvx=zero, ref=zero)
        pred = l0["pred"]
    # signalling bits: MVD vs the left-neighbour predictor (AMVP-rate
    # analog) + flags
    pmx = l0["mvx"].reshape(ny, nx)
    pmy = l0["mvy"].reshape(ny, nx)
    zc = torch.zeros((ny, 1), dtype=pmx.dtype, device=dev)
    pmx = torch.cat([zc, pmx[:, :-1]], 1).reshape(-1)
    pmy = torch.cat([zc, pmy[:, :-1]], 1).reshape(-1)
    # the MVD bits log2(1 + |Δx|) + log2(1 + |Δy|) + 6
    l2 = _log2_sum(l0["mvx"] - pmx, l0["mvy"] - pmy)
    mvb = l2 + np.float32(6.0)
    rd = _inter_rd(ob, pred, qp, bit_depth, mvb)
    aff = zero
    cp0 = cp1 = torch.zeros((n, 3, 2), dtype=torch.int32, device=dev)
    if affine_res:
        if len(affine_res) == 2:
            # list 1 only where strictly cheaper
            adir = torch.where(affine_res[1][0] < affine_res[0][0], 2, 1
                               ).to(torch.int32)
            apred = torch.where((adir == 2)[:, None, None],
                                affine_res[1][2], affine_res[0][2])
            acp1 = affine_res[1][1]
        else:
            adir = torch.ones(n, dtype=torch.int32, device=dev)
            apred = affine_res[0][2]
            acp1 = cp1
        acp0 = affine_res[0][1]
        # rate proxy: the seed's MVD bits + affine flag/type/idx bins + the
        # corner-delta MVDs
        dcp = (acp0[:, 1] - acp0[:, 0]).abs()
        ard = _inter_rd(ob, apred, qp, bit_depth, _affine_bits(l2, dcp))
        upd = ard < rd
        aff = torch.where(upd, 4, 0).to(torch.int32)
        rd = torch.where(upd, ard, rd)
        dirs = torch.where(upd, adir, dirs)
        cp0, cp1 = acp0, acp1
    out = [rd, dirs, l0["mvx"], l0["mvy"], l0["ref"], l1["mvx"], l1["mvy"],
           l1["ref"], aff, cp0, cp1]
    return torch.cat([o.to(torch.float32).reshape(-1) for o in out])


def me_v2_program(y, refpad, coarse, qp: int, size: int, bit_depth: int,
                  w: int, h: int, n_l0: int, n_l1: int, is_b: bool,
                  affine: bool, children: bool):
    """vvc/enc/inter_search.py:249 `_me_v2_program`: one size class over
    every (list, ref) → (packed_parent, packed_child | None) float32
    vectors.  y [h, w] int32; refpad [R, h+2P, w+2P] (l0 refs then l1);
    coarse [R, nc_y, nc_x, 2] full-pel (mvy, mvx) for this size (the
    16-grid with children); affine: the affine search of reference 0 of
    each list at sizes 16, 32 and 64."""
    s = size
    dev = y.device
    if children:
        ny8, nx8 = h // 8, w // 8
        nye, nxe = (ny8 + 1) // 2, (nx8 + 1) // 2
    else:
        nye, nxe = h // s, w // s
    n = nye * nxe
    yp = y
    if nye * s > h or nxe * s > w:
        ry = torch.arange(nye * s, device=dev).clamp(max=h - 1)
        rx = torch.arange(nxe * s, device=dev).clamp(max=w - 1)
        yp = y[ry][:, rx]
    ob = me_mod.raster_blocks(yp, nye, nxe, s).to(torch.int32)
    xs = (torch.arange(nxe, device=dev, dtype=torch.int32) * s).repeat(nye)
    ys = (torch.arange(nye, device=dev, dtype=torch.int32) * s
          ).repeat_interleave(nxe)
    _, lam_m = lambda_f32(qp)

    nc_y, nc_x = coarse.shape[1], coarse.shape[2]
    giy = (torch.arange(nye, device=dev).repeat_interleave(nxe)
           ).clamp(max=nc_y - 1)
    gix = torch.arange(nxe, device=dev).repeat(nye).clamp(max=nc_x - 1)
    if children:
        sub_y = torch.tensor([0, 0, 8, 8], dtype=torch.int32, device=dev)
        sub_x = torch.tensor([0, 8, 0, 8], dtype=torch.int32, device=dev)
        ys_c = (ys[:, None] + sub_y).reshape(-1)
        xs_c = (xs[:, None] + sub_x).reshape(-1)
        obc = (yp[:nye * 16, :nxe * 16].reshape(nye, 2, 8, nxe, 2, 8)
               .permute(0, 3, 1, 4, 2, 5).reshape(-1, 8, 8)
               .to(torch.int32).contiguous())

    n_refs = (n_l0, n_l1 if is_b else 0)
    per_list = [None, None]
    ref0_res = [None, None]
    child_list = [None, None]
    for li in (0, 1):
        best = cbest = None
        for ridx in range(n_refs[li]):
            st = ridx if li == 0 else n_l0 + ridx
            rp = refpad[st]
            iy, ix, cy, cx = me_mod.int_refine(
                rp, ob, ys, xs, coarse[st, giy, gix, 0],
                coarse[st, giy, gix, 1], lam_m, s, h, w)
            mvy, mvx, cost, pred = me_mod.qpel_refine(
                rp, ob, ys, xs, iy, ix, lam_m, s, bit_depth)
            if ridx == 0:
                ref0_res[li] = (st, iy, ix, mvy, mvx)
            ent = dict(mvy=mvy, mvx=mvx, cost=cost, pred=pred,
                       ref=torch.full((n,), ridx, dtype=torch.int32,
                                      device=dev))
            best = ent if best is None else _run_min(best, ent)
            if children:
                # the four 8×8 sub-blocks search their parent's window
                # around the parent's (clipped) centre
                iyc, ixc, _, _ = me_mod.int_refine(
                    rp, obc, ys_c, xs_c, cy.repeat_interleave(4),
                    cx.repeat_interleave(4), lam_m, 8, h, w)
                mvy, mvx, cost, pred = me_mod.qpel_refine(
                    rp, obc, ys_c, xs_c, iyc, ixc, lam_m, 8, bit_depth)
                cent = dict(mvy=mvy, mvx=mvx, cost=cost, pred=pred,
                            ref=torch.full((4 * n,), ridx, dtype=torch.int32,
                                           device=dev))
                cbest = cent if cbest is None else _run_min(cbest, cent)
        per_list[li] = best
        child_list[li] = cbest

    aff_res = None
    if affine and s in me_mod.AFFINE_ME_SIZES:
        aff_res = []
        for li in (0, 1):
            if n_refs[li] == 0:
                continue
            st, iy, ix, mvy, mvx = ref0_res[li]
            ac, da, db, apred = me_mod.affine_search(
                refpad[st], ob, ys, xs, mvy, mvx, iy, ix, lam_m, s, bit_depth)
            # CPMV (x, y) of the centre-rooted candidate field: cp1 − cp0 =
            # (da, db); `//` floors, as jnp's does
            h_ab, h_ba, h_s = (da + db) // 2, (db - da) // 2, (da - db) // 2
            cp = torch.stack([
                torch.stack([mvx + h_ba, mvy - h_ab], -1),
                torch.stack([mvx + h_ab, mvy + h_ba], -1),
                torch.stack([mvx - h_ab, mvy + h_s], -1)], 1)
            aff_res.append((ac, cp.to(torch.int32), apred))

    # parent grids: slice synthetic rows/cols before the finish pass
    nyv, nxv = h // s, w // s
    if children and (nye != nyv or nxe != nxv):
        def _sl(f):
            tail = tuple(f.shape[1:])
            return (f.reshape((nye, nxe) + tail)[:nyv, :nxv]
                    .reshape((-1,) + tail))
        per_list = [None if d is None else {k: _sl(v) for k, v in d.items()}
                    for d in per_list]
        if aff_res is not None:
            aff_res = [(_sl(c), _sl(cp), _sl(p)) for c, cp, p in aff_res]
        ob_f = me_mod.raster_blocks(y, nyv, nxv, s).to(torch.int32)
    else:
        ob_f = ob
    packed = _finish(per_list[0], per_list[1], ob_f, qp, bit_depth, lam_m,
                     nyv, nxv, is_b, aff_res)
    packed_c = None
    if children:
        cl = [None if d is None else
              {k: _reorder_children(v, nye, nxe, ny8, nx8)
               for k, v in d.items()} for d in child_list]
        ob8 = me_mod.raster_blocks(y, ny8, nx8, 8).to(torch.int32)
        packed_c = _finish(cl[0], cl[1], ob8, qp, bit_depth, lam_m,
                           ny8, nx8, is_b)
    return packed, packed_c


_FIELDS = ("cost", "dir", "mvx0", "mvy0", "ref0", "mvx1", "mvy1", "ref1",
           "aff")


def unpack_inter(v: np.ndarray, s: int, w: int, h: int):
    """Host-side inverse of a size's packed vector → {field: [ny, nx]}
    (vvc/enc/inter_search.py:479-494)."""
    ny, nx = h // s, w // s
    n = ny * nx
    ent = {}
    off = 0
    for f in _FIELDS:
        fv = v[off:off + n]
        ent[f] = (fv if f == "cost" else fv.astype(np.int32)).reshape(ny, nx)
        off += n
    ent["cp0"] = v[off:off + n * 6].astype(np.int32).reshape(ny, nx, 3, 2)
    off += n * 6
    ent["cp1"] = v[off:off + n * 6].astype(np.int32).reshape(ny, nx, 3, 2)
    return ent


def rdo_inter_partition(y_plane: np.ndarray, refs_l0, refs_l1, qp: int,
                        bit_depth: int = 8, ctu_size: int = 64,
                        min_cu: int = 8, is_b: bool = False,
                        search_range: int = 32, mts_enabled: bool = True,
                        affine: bool = False, device=None):
    """Partition + per-CU mode decision for a P/B frame (same signature as
    vvc's plus `device`: None = CUDA, raises without it; "cpu" runs the
    plain path).  refs_l0 / refs_l1: lists of reference luma planes
    (nearest first).  Returns (split_map, leaf_map, leaves) with the inter
    fields set."""
    dev = resolve_device(device)
    h, w = y_plane.shape
    sizes = _candidate_sizes(ctu_size, min_cu)

    # program (1): intra costs for all sizes, as vvc runs it
    packed_intra = eval_all_sizes(
        torch.from_numpy(pack_planes(y_plane)).to(dev), tuple(sizes), qp,
        bit_depth, w, h)

    # program (2): cached padded + ds4 reference planes (l0 then l1)
    n_l0, n_l1 = len(refs_l0), len(refs_l1) if is_b else 0
    pads, dss = [], []
    for ref in list(refs_l0) + (list(refs_l1) if is_b else []):
        pp, ds = me_mod.pic_dev(ref, dev)
        pads.append(pp)
        dss.append(ds)
    refpad = torch.stack(pads)
    y_dev = torch.from_numpy(np.ascontiguousarray(y_plane, dtype=np.int32)
                             ).to(dev)
    _, yds = me_mod.prep_ref(y_dev)
    coarse = me_mod.coarse_search(yds, torch.stack(dss), me_mod.COARSE_R)

    me_sizes = sorted([s for s in sizes if ME_SIZES_MIN <= s <= 64],
                      reverse=True)
    packed_by_size = {}
    for s in me_sizes:
        if s == 8 or h < s or w < s:
            continue                       # 8 rides the 16-program
        children = (s == 16 and 8 in me_sizes)
        pk, pkc = me_v2_program(y_dev, refpad, coarse[s], qp, s, bit_depth,
                                w, h, n_l0, n_l1, is_b, affine, children)
        packed_by_size[s] = pk
        if children:
            packed_by_size[8] = pkc

    intra_res = unpack_results(packed_intra.cpu().numpy(), sizes, w, h)
    inter = {s: unpack_inter(packed_by_size[s].cpu().numpy(), s, w, h)
             for s in me_sizes if s in packed_by_size}
    return _dp_backtrack_inter(intra_res, inter, w, h, qp, sizes, ctu_size,
                               min_cu)


def _dp_backtrack_inter(intra_res, inter, w, h, qp, sizes, ctu_size, min_cu):
    """Bottom-up DP over the size pyramid with per-node intra/inter choice
    (mirrors rdo._dp_backtrack; kept separate for the extra payloads)."""
    lam = rd_lambda(qp)
    cost, choose_inter = {}, {}
    for s in sizes:
        nx, ny = w // s, h // s
        cost[s] = np.full((ny, nx), np.inf)
        choose_inter[s] = np.zeros((ny, nx), dtype=bool)
        if s in intra_res:
            cost[s][:] = intra_res[s][0]
        if s in inter:
            ic = inter[s]["cost"]
            choose_inter[s] = ic < cost[s]
            cost[s] = np.minimum(cost[s], ic)

    best = {min_cu: cost[min_cu].copy()}
    use_split = {}
    for s in sizes[1:]:
        half = s // 2
        ny, nx = h // s, w // s
        ch = best[half]
        child_sum = (ch[0::2, 0::2][:ny, :nx] + ch[0::2, 1::2][:ny, :nx]
                     + ch[1::2, 0::2][:ny, :nx] + ch[1::2, 1::2][:ny, :nx])
        split_cost = child_sum + lam * SPLIT_BITS
        leaf_cost = cost[s][:ny, :nx] + lam * SPLIT_BITS
        use_split[s] = split_cost < leaf_cost
        best[s] = np.where(use_split[s], split_cost, leaf_cost)

    split_map, leaf_map, leaves = {}, {}, []

    def make_leaf(x0, y0, s):
        by, bx = y0 // s, x0 // s
        if choose_inter[s][by, bx]:
            e = inter[s]
            d = int(e["dir"][by, bx])
            if "aff" in e and int(e["aff"][by, bx]):
                cp = e["cp0"] if d == 1 else e["cp1"]
                cpmv = tuple((int(cp[by, bx, c, 0]), int(cp[by, bx, c, 1]))
                             for c in range(2))
                cps = [None, None]
                cps[d - 1] = cpmv
                return Leaf(x0, y0, s, s, pred=1, inter_dir=d,
                            ref_idx=(0, 0), affine=4, cpmv=tuple(cps))
            mv = [(int(e["mvx0"][by, bx]), int(e["mvy0"][by, bx])), (0, 0)]
            ref = [int(e["ref0"][by, bx]), 0]
            if d >= 2:
                mv[1] = (int(e["mvx1"][by, bx]), int(e["mvy1"][by, bx]))
                ref[1] = int(e["ref1"][by, bx])
                if d == 2:
                    mv[0] = (0, 0)
                    ref[0] = 0
            return Leaf(x0, y0, s, s, pred=1, inter_dir=d, mv=tuple(mv),
                        ref_idx=tuple(ref))
        mode = int(intra_res[s][1][by, bx]) if s in intra_res else 0
        mts = int(intra_res[s][2][by, bx]) if s in intra_res else 0
        return Leaf(x0, y0, s, s, mode, mts=mts)

    def walk(x0, y0, s):
        if x0 >= w or y0 >= h:
            return
        if s > 64:
            # MaxCUSize 64: CTU-128 nodes split implicitly (no flag)
            half = s // 2
            for dx, dy in ((0, 0), (half, 0), (0, half), (half, half)):
                walk(x0 + dx, y0 + dy, half)
            return
        inside = x0 + s <= w and y0 + s <= h
        if not inside:
            half = s // 2
            for dx, dy in ((0, 0), (half, 0), (0, half), (half, half)):
                walk(x0 + dx, y0 + dy, half)
            return
        if s > min_cu and use_split[s][y0 // s, x0 // s]:
            split_map[(x0, y0, s, s)] = SPLIT_QT
            half = s // 2
            for dx, dy in ((0, 0), (half, 0), (0, half), (half, half)):
                walk(x0 + dx, y0 + dy, half)
        else:
            if s > min_cu:
                split_map[(x0, y0, s, s)] = SPLIT_NONE
            leaf = make_leaf(x0, y0, s)
            leaf_map[(x0, y0, s, s)] = leaf
            leaves.append(leaf)

    for cy in range(0, h, ctu_size):
        for cx in range(0, w, ctu_size):
            walk(cx, cy, ctu_size)
    return split_map, leaf_map, leaves


# ---------------------------------------------------------------------------
# the r4 engine: integer full search, fractional refine over phase planes
# ---------------------------------------------------------------------------
#
# vvc/enc/inter_search.py:70 `_int_me_dev` scores every offset of ±R around
# a centre by SSE(d) = Σw²(d) − 2·corr(d) (+ Σo², a constant): the window
# energy from a float32 integral image, the correlation by a grouped
# convolution.  Its float32 arithmetic, as XLA-CPU compiles it (jax 0.9.0,
# optimised HLO and x86 object code of `me_pred_program`):
#   * each `jnp.cumsum` of the integral image becomes a blocked
#     reduce-window: blocks of 16, a sequential prefix inside each, plus the
#     sequential sum of the earlier blocks' totals (`xla_cumsum`);
#   * e = ((ii[d+S, d'+S] − ii[d+S, d']) − ii[d, d'+S]) + ii[d, d'];
#   * the convolution is a runtime Eigen call; its order is not reproduced:
#     the port sums it exactly and rounds once, which is vvc's value
#     whenever it is below 2^24 (8-bit samples at S ≤ 16);
#   * cost = fma(λ_m, bits(4(cy+d−R)) + bits(4(cx+d'−R)), e − 2·corr), the
#     first minimum in raster order.
# vvc maps chunks of CHUNK = 1024 blocks (zero-padded) through `lax.map`;
# every block is computed alone, so the port runs them all at once.

CHUNK = 1024


def xla_cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """float32 cumulative sum along `dim` in XLA-CPU's blocked order: a
    sequential prefix inside each block of 16, plus the sequential float32
    sum of the earlier blocks' totals."""
    x = x.to(torch.float32).movedim(dim, 0)
    out = torch.empty_like(x)
    base = torch.zeros_like(x[0])
    for b in range(0, x.shape[0], 16):
        acc = torch.zeros_like(x[0])
        for i in range(b, min(b + 16, x.shape[0])):
            acc = acc + x[i]
            out[i] = acc + base
        base = base + acc
    return out.movedim(0, dim)


def int_me_plain(blocks: torch.Tensor, ref: torch.Tensor, xs, ys, size: int,
                 radius: int, lam_m, cx0, cy0):
    """Plain twin of `_int_me_dev`: blocks [N, S, S] and ref [H, W]
    (integer samples), block origins xs, ys and centres cx0, cy0 [N] →
    full-pel (mvx, mvy) int32 [N]."""
    s, r = size, radius
    D, L = 2 * r + 1, size + 2 * radius
    h, w = ref.shape
    dev = ref.device
    cx0 = cx0.to(torch.int64)
    cy0 = cy0.to(torch.int64)
    k = torch.arange(L, device=dev)
    yy = (ys.to(torch.int64)[:, None] + cy0[:, None] - r + k).clamp(0, h - 1)
    xx = (xs.to(torch.int64)[:, None] + cx0[:, None] - r + k).clamp(0, w - 1)
    win = ref.to(torch.int64)[yy[:, :, None], xx[:, None, :]]
    bl = blocks.to(torch.int64)
    corr = torch.zeros((win.shape[0], D, D), dtype=torch.int64, device=dev)
    for i in range(s):
        for j in range(s):
            corr += win[:, i:i + D, j:j + D] * bl[:, i, j, None, None]
    ii = xla_cumsum(xla_cumsum((win * win).to(torch.float32), 1), 2)
    ii = torch.nn.functional.pad(ii, (1, 0, 1, 0))
    e = ((ii[:, s:s + D, s:s + D] - ii[:, s:s + D, :D])
         - ii[:, :D, s:s + D]) + ii[:, :D, :D]
    sse = e - 2.0 * corr.to(torch.float32)
    d = torch.arange(D, device=dev)
    by = me_mod.mv_bits(4 * (cy0[:, None] + d - r))
    bx = me_mod.mv_bits(4 * (cx0[:, None] + d - r))
    cost = _fma_f32(np.float32(lam_m), by[:, :, None] + bx[:, None, :], sse)
    flat = torch.argmin(cost.reshape(cost.shape[0], -1), dim=1)
    return ((cx0 + flat % D - r).to(torch.int32),
            (cy0 + flat // D - r).to(torch.int32))


def _int_me_cuda(blocks, ref, xs, ys, size: int, radius: int, lam_m, cx0,
                 cy0):
    ops.check_cuda_i32("me_full", blocks, ref, xs, ys, cx0, cy0)
    n = blocks.shape[0]
    if tuple(blocks.shape[1:]) != (size, size) or not 0 <= radius <= 64 \
            or size + 2 * radius > 256:
        raise ValueError(f"me_full: blocks {tuple(blocks.shape)}, radius "
                         f"{radius}")
    dev = blocks.device
    mvx = torch.empty(n, dtype=torch.int32, device=dev)
    mvy = torch.empty_like(mvx)
    if n == 0:
        return mvx, mvy
    # the largest sample bounds the correlation's integer accumulator
    maxv = max(int(blocks.max()), int(ref.max()), 0)
    fn = ops.lib("me_full").me_full_launch
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_float]
                   + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    err = fn(blocks.data_ptr(), ref.data_ptr(), xs.data_ptr(), ys.data_ptr(),
             cx0.data_ptr(), cy0.data_ptr(),
             me_mod._mv_bits_dev(str(dev)).data_ptr(),
             float(np.float32(lam_m)), n, size, radius, ref.shape[0],
             ref.shape[1], maxv, mvx.data_ptr(), mvy.data_ptr(),
             ops.stream_ptr(blocks))
    ops.launched("me_full", err)
    return mvx, mvy


def int_me(blocks: torch.Tensor, ref: torch.Tensor, xs, ys, size: int,
           radius: int, lam_m, cx0, cy0):
    """vvc/enc/inter_search.py:70 `_int_me_dev` → full-pel (mvx, mvy) int32
    [N].  The samples are non-negative integers (vvc passes them as
    float32).  CUDA tensors →
    vvc_torch/csrc/me.cu `me_full`; CPU tensors or `ops.plain()` →
    int_me_plain."""
    reach = 4 * (max(int(cx0.abs().max()), int(cy0.abs().max()))
                 + radius) if cx0.numel() else 0
    if reach >= me_mod.MV_BITS_N:
        raise ValueError(f"int_me: |MV| up to {reach} qpel is outside the "
                         f"MV-bits table")
    if ops.use_kernel(blocks):
        return _int_me_cuda(*(t.to(torch.int32).contiguous() for t in
                              (blocks, ref, xs, ys)), size, radius, lam_m,
                            cx0.to(torch.int32).contiguous(),
                            cy0.to(torch.int32).contiguous())
    return int_me_plain(blocks, ref, xs, ys, size, radius, lam_m, cx0, cy0)


_FRAC_OFF = [(0, 0), (-1, 0), (1, 0), (0, -1), (0, 1),
             (-1, -1), (1, -1), (-1, 1), (1, 1)]


def frac_refine(orig: torch.Tensor, planes: torch.Tensor, xs, ys, mvx, mvy,
                size: int, lam_m):
    """vvc/enc/inter_search.py:130 `_frac_refine_dev`: the half-pel, then
    the quarter-pel stage, each over the 8 offsets of `_FRAC_OFF` taken
    from the running best (a candidate that wins moves the centre of the
    ones after it); cost fma(λ_m, bits(cx) + bits(cy), SATD) (XLA-CPU's
    contraction), a strict `<` keeping the earlier candidate.  Returns
    (mvx, mvy int32 [N], cost float32 [N])."""
    lam = np.float32(lam_m)
    orig = orig.to(torch.int32)

    def cost(cx, cy):
        pred = gather_pred_planes(planes, xs, ys, cx, cy, size)
        return _fma_f32(lam, me_mod.mv_bits(cx) + me_mod.mv_bits(cy),
                        satd_batch(pred, orig).to(torch.float32))

    mvx = mvx.to(torch.int32)
    mvy = mvy.to(torch.int32)
    best = cost(mvx, mvy)
    for step in (2, 1):
        for dx, dy in _FRAC_OFF[1:]:
            cx, cy = mvx + dx * step, mvy + dy * step
            c = cost(cx, cy)
            m = c < best
            best = torch.where(m, c, best)
            mvx = torch.where(m, cx, mvx)
            mvy = torch.where(m, cy, mvy)
    return mvx, mvy, best


def me_pred_program(y: torch.Tensor, phase: torch.Tensor, size: int,
                    radius: int, w: int, h: int, lam_m):
    """vvc/enc/inter_search.py:391 `me_pred_program`: single-reference ME of
    every size×size block of y [H, W] against the reference whose phase
    planes are `phase` [4, 4, H, W] (`kernels.mc.interp_luma_planes`):
    `int_me` from centre 0, `frac_refine`, then the prediction
    (`gather_pred_planes`) → (plane [ny·S, nx·S] int32, err [ny, nx]
    float32 = mean((pred − block)²)).  vvc's float32 sum of the error runs
    row-major from 0 (read from its object code at S = 16): the SSE mode
    of kernel `block_dist`, times 1/S² (exact)."""
    s = size
    dev = y.device
    ny, nx = h // s, w // s
    blocks = me_mod.raster_blocks(y, ny, nx, s).to(torch.int32)
    xs = (torch.arange(nx, device=dev, dtype=torch.int32) * s).repeat(ny)
    ys = (torch.arange(ny, device=dev, dtype=torch.int32) * s
          ).repeat_interleave(nx)
    zero = torch.zeros(ny * nx, dtype=torch.int32, device=dev)
    ix, iy = int_me(blocks, phase[0, 0], xs, ys, s, radius, lam_m, zero,
                    zero)
    fx, fy, _ = frac_refine(blocks, phase, xs, ys, ix * 4, iy * 4, s, lam_m)
    pred = gather_pred_planes(phase, xs, ys, fx, fy, s)
    err = sse_batch(pred, blocks) * (1.0 / (s * s))
    plane = (pred.reshape(ny, nx, s, s).permute(0, 2, 1, 3)
             .reshape(ny * s, nx * s))
    return plane, err.reshape(ny, nx)

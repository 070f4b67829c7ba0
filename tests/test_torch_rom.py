"""The tables the port carries across from vvc — its "weights" — equal
vvc's: intra angular/PDPC tables and filters, transform matrices, scans
and quant scales, MIP and LFNST matrices, CABAC context init and measured
rates, XLA's float32 log table behind the level rate, the RDO mode, MTS
and MIP bits, the APS writer, and the native CABAC and reconstruction
cores' sources.  Tolerance: exact equality."""
import os

import numpy as np
import pytest

import vvc.cabac.ctx as ref_ctx
import vvc.cabac.rates as ref_rates
import vvc.cabac.rates_ctx as ref_rates_ctx
import vvc.cabac.residual as ref_residual
import vvc.enc.rdo as ref_rdo
import vvc.kernels.intra as ref_intra
import vvc.rom.intra_filters as ref_filt
import vvc.rom.lfnst_mats as ref_lfnst
import vvc.rom.mip_mats as ref_mip
import vvc.rom.transform_mats as ref_tm
import vvc_torch.cabac.ctx as port_ctx
import vvc_torch.cabac.rates as port_rates
import vvc_torch.cabac.rates_ctx as port_rates_ctx
import vvc_torch.cabac.residual as port_residual
import vvc_torch.rom.intra_filters as port_filt
import vvc_torch.rom.lfnst_mats as port_lfnst
import vvc_torch.rom.log_table as port_log
import vvc_torch.rom.mip_mats as port_mip
import vvc_torch.rom.transform_mats as port_tm

# vvc_torch modules that import torch (enc.rdo, kernels.intra) are imported
# inside the tests, so that a worker that never runs them does not load
# torch beside JAX.
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _eq(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _eq(a[k], b[k])
    elif isinstance(a, (tuple, list)) and not np.isscalar(a):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _eq(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("size", (4, 8, 16, 32, 64))
def test_intra_tables_equal(size):
    import vvc_torch.kernels.intra as port_intra
    _eq(port_intra._stacked_tables(size), ref_intra._stacked_tables(size))
    vm = tuple(range(34, 67))
    _eq(port_intra._stacked_pdpc(size, size, vm),
        ref_intra._stacked_pdpc(size, size, vm))


def test_intra_filters_equal():
    _eq(port_filt.fc_filters(), ref_filt.fc_filters())
    _eq(port_filt.fg_filters(), ref_filt.fg_filters())
    _eq(port_filt.SMOOTH_THRES, ref_filt.SMOOTH_THRES)


def test_transform_tables_equal():
    for tr in (0, 1, 2):
        for n in (4, 8, 16, 32, 64):
            if tr and n > 32:
                continue
            _eq(port_tm.transform_matrix(tr, n), ref_tm.transform_matrix(tr, n))
    for w in (1, 2, 4, 8, 16, 32, 64):
        for h in (1, 2, 4, 8, 16, 32, 64):
            _eq(port_tm.diag_scan(w, h), ref_tm.diag_scan(w, h))
    for name in ("QUANT_SCALES", "INV_QUANT_SCALES", "QUANT_SCALES_RECT",
                 "INV_QUANT_SCALES_RECT", "QUANT_SHIFT", "IQUANT_SHIFT"):
        _eq(getattr(port_tm, name), getattr(ref_tm, name))
    for l2 in range(1, 7):
        _eq(port_residual.full_scan(l2), ref_residual.full_scan(l2))


def test_mip_lfnst_matrices_equal():
    _eq(port_mip.mip_weights(), ref_mip.mip_weights())
    _eq(port_mip.K_MIP_MODES, ref_mip.K_MIP_MODES)
    _eq(port_lfnst.lfnst_kernels(), ref_lfnst.lfnst_kernels())


def test_xla_log_table_regenerated_from_jnp():
    """Every entry of the port's float32 log table is XLA-CPU's jnp.log of
    1..32768, bit for bit (the level rate's log2 is log·(1/ln 2) there)."""
    import jax
    import jax.numpy as jnp
    x = jnp.arange(1, port_log.N_LOG + 1, dtype=jnp.int32).astype(jnp.float32)
    want = np.asarray(jax.jit(jnp.log)(x))
    got = port_log.xla_log_f32()
    assert got.dtype == np.float32 and got.shape == (port_log.N_LOG,)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    log2 = np.asarray(jax.jit(jnp.log2)(x))
    np.testing.assert_array_equal(
        (got * port_rates.log_scale_f32() / np.float32(2)).view(np.uint32),
        log2.view(np.uint32))


def test_cabac_context_tables_equal():
    _eq(port_ctx.CTX_SETS, ref_ctx.CTX_SETS)
    _eq(port_ctx.INIT_STATES, ref_ctx.INIT_STATES)
    _eq(port_ctx.RESIDUAL_SET_ORDER, ref_ctx.RESIDUAL_SET_ORDER)
    for qp in (0, 22, 32, 37, 51, 63):
        _eq(port_ctx.SliceContexts(qp).states, ref_ctx.SliceContexts(qp).states)
    _eq(port_rates_ctx.CTX_RATES, ref_rates_ctx.CTX_RATES)
    _eq(port_rates.LEVEL_BITS_TABLE, ref_rates.LEVEL_BITS_TABLE)
    _eq(port_rates.SYNTAX_BITS, ref_rates.SYNTAX_BITS)


def test_rdo_constants_equal():
    import vvc_torch.enc.rdo as port_rdo
    _eq(port_rdo._MODE_BITS, ref_rdo._MODE_BITS)
    _eq(port_rdo._MTS_BITS, ref_rdo._MTS_BITS)
    _eq(port_rdo._MIP_BITS, ref_rdo._MIP_BITS)
    _eq(port_rdo.RD_SHORTLIST, ref_rdo.RD_SHORTLIST)
    for name in ("SPLIT_LEAF_BITS", "SPLIT_BITS", "QT_FLAG_BITS",
                 "MTT_FLAG_BITS", "MTT_DIR_BITS", "BT_FLAG_BITS",
                 "TT_FLAG_BITS", "TT_MARGIN_BITS"):
        assert getattr(port_rdo, name) == getattr(ref_rdo, name)
    for qp in range(64):
        assert port_rdo.rd_lambda(qp) == ref_rdo.rd_lambda(qp)


def test_cabac_core_source_equal_but_comments():
    """The native core is a copy; only a comment naming the reference's
    source path differs."""
    def code(path):
        with open(os.path.join(ROOT, path)) as fh:
            return [l for l in fh.read().splitlines()
                    if not l.lstrip().startswith("//")]
    assert (code("vvc_torch/packer/cabac_core.cpp")
            == code("vvc/packer/cabac_core.cpp"))


def test_recon_core_source_equal_but_comments():
    """The reconstruction core is a copy too; only comments differ."""
    def code(path):
        with open(os.path.join(ROOT, path)) as fh:
            return [l for l in fh.read().splitlines()
                    if not l.lstrip().startswith("//")]
    assert (code("vvc_torch/packer/recon_core.cpp")
            == code("vvc/packer/recon_core.cpp"))

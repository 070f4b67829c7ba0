"""Measured level-rate model for RD search and the dep-quant trellis.

TPU-native analog of the reference's CABAC bit estimation
(`VTM/source/Lib/CommonLib/Contexts.cpp` →
BinProbModel_Std::estFracBits — a per-context LUT of -log2(p) driven
through the estimator CABACWriter).  The reference prices every bin from
live context state; we use a *measured average* rate per level magnitude:
the table below was fit by least squares (R² = 0.99) against the actual
bit counts of this repo's own residual coder (vvc_torch.cabac.residual
write_residual with adapting contexts) over 455 quantized 8×8 transform
blocks spanning QP-32-like level statistics (see tools/measure_rates.py).

This prices the sig/gt1/parity/gt3/EG-remainder structure correctly on
average — in particular zeros cost ~0.45 bits (significance flags), not
the ~0 the old heuristic assumed — while staying a pure gather, usable
both on device (RDO) and in the host trellis.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

from vvc_torch.rom.log_table import xla_log_f32

# measured average bits to code |level| = k (luma, adapted contexts);
# index 0..9, extrapolated beyond with the EG-remainder slope measured 2.0
# bits/octave (monotonized from the raw fit)
LEVEL_BITS_TABLE = np.array(
    [0.45, 3.22, 4.13, 4.50, 5.60, 6.20, 6.60, 7.00, 7.60, 8.00],
    dtype=np.float32)
_EG_SLOPE = 2.0  # extra bits per doubling beyond the table


def level_bits_np(abs_lev: np.ndarray) -> np.ndarray:
    """Average coding cost in bits for |level| array (any shape)."""
    a = np.asarray(abs_lev)
    k = np.minimum(a, len(LEVEL_BITS_TABLE) - 1)
    base = LEVEL_BITS_TABLE[k]
    over = np.maximum(a.astype(np.float32) - (len(LEVEL_BITS_TABLE) - 1), 0.0)
    return base + _EG_SLOPE * np.log2(1.0 + over)


# float32 bits of 1/ln 2 as XLA folds log2(x) = log(x)·(1/ln 2); times the
# EG slope (a power of two) it stays exact: the factor of the one FMA
# level_bits_jnp compiles to, base + log(1 + over)·(2/ln 2)
_INV_LN2_F32_BITS = 0x3FB8AA3B
MAX_LEVEL = 32767     # quant clips |level| to 15 bits


def log_scale_f32() -> np.float32:
    """float32 2/ln 2, the multiplier of log(1 + over) in the level rate."""
    inv_ln2 = np.array([_INV_LN2_F32_BITS], dtype=np.uint32).view(
        np.float32)[0]
    return np.float32(_EG_SLOPE) * inv_ln2


@lru_cache(maxsize=None)
def level_bits_table() -> np.ndarray:
    """[32768] float32: the rate of |level| = 0..32767 bit for bit as
    vvc's jitted `level_bits_jnp` computes it on XLA-CPU: one FMA,
    fma(log(1 + over), 2/ln 2, base), with XLA's own float32 log
    (vvc_torch/rom/log_table.py).  The FMA is evaluated in float64 (the
    product of two float32 is exact there); the single float64 rounding
    before the float32 one changes no entry (tests/test_torch_quant.py
    compares all 32768 with JAX)."""
    a = np.arange(MAX_LEVEL + 1)
    k = np.minimum(a, len(LEVEL_BITS_TABLE) - 1)
    over = np.maximum(a - (len(LEVEL_BITS_TABLE) - 1), 0)
    log = xla_log_f32()[over].astype(np.float64)          # log(1 + over)
    val = (LEVEL_BITS_TABLE[k].astype(np.float64)
           + log * np.float64(log_scale_f32())).astype(np.float32)
    val.setflags(write=False)
    return val


@lru_cache(maxsize=None)
def _level_bits_dev(device: str):
    import torch   # host users of this module (depquant, rdo DP) need none
    return torch.from_numpy(level_bits_table().copy()).to(device)


def level_bits(abs_lev):
    """Torch twin of vvc/cabac/rates.py:41 level_bits_jnp: |level| int
    tensor (0..32767) → float32 bits, bit-equal to XLA's values."""
    tab = _level_bits_dev(str(abs_lev.device))
    return tab[abs_lev.clamp(0, MAX_LEVEL).long()]


def level_bits_scalar(l: int) -> float:
    if l < len(LEVEL_BITS_TABLE):
        return float(LEVEL_BITS_TABLE[l])
    return float(LEVEL_BITS_TABLE[-1]
                 + _EG_SLOPE * np.log2(1.0 + l - (len(LEVEL_BITS_TABLE) - 1)))


# ---------------------------------------------------------------------------
# Measured syntax-bin rates (estFracBits analog for non-level syntax).
#
# Average -log2(p(bin)) per (context family, bin value) measured over real
# encodes of this repo's own CABAC (adapting contexts) by
# tools/measure_syntax_rates.py — structured-bars + synthetic content,
# QP {22,32,37}, MTT+ISP on.  The reference prices these bins from live
# per-node context state (Contexts.cpp → BinProbModel_Std::estFracBits);
# our partition DP is global, so the adapted *average* is the consistent
# estimator (same methodology as LEVEL_BITS_TABLE above).
SYNTAX_BITS = {
    "SPLIT_CU_FLAG": {0: 1.543, 1: 0.465},
    "SPLIT_QT_FLAG": {0: 1.109, 1: 0.800},
    "MTT_SPLIT_VERT": {0: 1.127, 1: 0.908},
    "MTT_SPLIT_BINARY": {0: 2.165, 1: 0.585},   # 0 = TT, 1 = BT
    "INTRA_LUMA_MPM_FLAG": {0: 1.021, 1: 0.930},
    "INTRA_LUMA_NOT_PLANAR": {0: 1.442, 1: 0.488},
    "MIP_FLAG": {0: 0.479, 1: 1.893},
    "ISP_MODE": {0: 0.511, 1: 1.269},
    "CCLM_FLAG": {0: 0.162, 1: 2.368},
    "CBF_LUMA": {0: 1.633, 1: 0.278},
    "MTS_IDX": {0: 0.940, 1: 0.944},
    "LFNST_IDX": {0: 0.399, 1: 3.213},
}


def syntax_bits(family: str, bin_val: int) -> float:
    return SYNTAX_BITS[family][bin_val]

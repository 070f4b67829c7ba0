"""Native host cores (ctypes): the CABAC packer and the reconstruction core.

Builds cabac_core.cpp and recon_core.cpp (copies of vvc/packer's) with g++
at first use into vvc_torch/_build/ (named by a hash of the source, so a
changed source rebuilds) and loads them.  There is no fallback: a failed
build raises.  The Python engine (vvc_torch.cabac.engine) and the numpy
reconstruction (vvc_torch.model.recon) stay the oracles the native cores
are tested against.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "cabac_core.cpp")
_RSRC = os.path.join(_DIR, "recon_core.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")

_lib = None
_rlib = None
_lock = threading.Lock()


def _load(src: str, stem: str) -> ctypes.CDLL:
    """Build `src` with g++ unless a library of its exact text exists, then
    load it.  Raises when the build or the load fails."""
    with open(src, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()[:12]
    so = os.path.join(_BUILD_DIR, f"lib{stem}-{digest}.so")
    if not os.path.exists(so):
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
                        "-o", tmp, src], check=True, capture_output=True,
                       timeout=300)
        os.replace(tmp, so)
    return ctypes.CDLL(so)


def recon_lib() -> ctypes.CDLL:
    """The native reconstruction core, built on first use; raises if it
    cannot be built or loaded."""
    global _rlib
    with _lock:
        if _rlib is not None:
            return _rlib
        l = _load(_RSRC, "recon")
        l.recon_init.argtypes = [ctypes.c_void_p] * 13
        l.mip_init.argtypes = [ctypes.c_void_p]
        l.lfnst_init.argtypes = [ctypes.c_void_p]
        l.intra_filt_init.argtypes = [ctypes.c_void_p] * 2
        l.depquant_init.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_double]
        l.quant_depquant_c.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_double, ctypes.c_void_p]
        l.dequant_depquant_c.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
        l.recon_leaves_v2.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_double,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        _rlib = l
        return _rlib


def lib() -> ctypes.CDLL:
    """The native CABAC core, built on first use; raises if it cannot be
    built or loaded."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        l = _load(_SRC, "cabac")
        l.enc_create.restype = ctypes.c_void_p
        l.enc_destroy.argtypes = [ctypes.c_void_p]
        l.enc_bin.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_int]
        l.enc_ep.argtypes = [ctypes.c_void_p, ctypes.c_int]
        l.enc_eps.argtypes = [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_int]
        l.enc_trm.argtypes = [ctypes.c_void_p, ctypes.c_int]
        l.enc_residual_c.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_int, ctypes.c_int, ctypes.c_int]
        l.enc_finish.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
        l.enc_finish.restype = ctypes.c_int64
        l.enc_bit_count.argtypes = [ctypes.c_void_p]
        l.enc_bit_count.restype = ctypes.c_int64
        l.dec_create.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        l.dec_create.restype = ctypes.c_void_p
        l.dec_destroy.argtypes = [ctypes.c_void_p]
        l.dec_bin.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
        l.dec_ep.argtypes = [ctypes.c_void_p]
        l.dec_eps.argtypes = [ctypes.c_void_p, ctypes.c_int]
        l.dec_eps.restype = ctypes.c_uint32
        l.dec_trm.argtypes = [ctypes.c_void_p]
        l.dec_residual_c.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_int, ctypes.c_int, ctypes.c_int]
        l.tw_create.restype = ctypes.c_void_p
        l.tw_create.argtypes = [ctypes.c_int] * 5
        l.tw_destroy.argtypes = [ctypes.c_void_p]
        l.tw_write.restype = ctypes.c_int64
        l.tw_write.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int]
        l.tr_create.restype = ctypes.c_void_p
        l.tr_create.argtypes = [ctypes.c_int] * 9
        l.tr_destroy.argtypes = [ctypes.c_void_p]
        l.tr_read.restype = ctypes.c_int64
        l.tr_read.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        _lib = l
        return _lib

"""Device resolution, CUDA kernel build/load and per-kernel launch counts.

Kernels are CUDA C++ for Hopper (`vvc_torch/csrc/*.cu`), each with a plain
C entry point `<kernel>_launch`.  `build()` compiles every source with its
own `nvcc` process, all started together, into `vvc_torch/_build/` (a
shared library per source, named by a hash of its text), and `lib(name)`
loads the library that holds kernel `name` with ctypes.  The build happens at first use and reads only the package's own
sources.

Each kernel wrapper (in `vvc_torch.kernels`, `vvc_torch.enc.rdo`,
`vvc_torch.enc.me`, `vvc_torch.enc.inter_search`, `vvc_torch.dec.wavefront`
and `vvc_torch.shard.filter`):
  * on a CPU tensor runs the kernel's plain PyTorch version;
  * on a CUDA tensor launches the kernel, or raises — unless the caller is
    inside `plain()`, the one explicit way to run the plain version on the
    card (used to hold a kernel against its plain version);
  * adds one to `COUNTS[name]` where it launches the kernel, and nowhere
    else.
"""
from __future__ import annotations

import contextlib
import contextvars
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_DIR, "csrc")
BUILD_DIR = os.path.join(_DIR, "_build")

# kernel name -> CUDA source (one plain-C shared library per source)
SOURCES = {
    "ref_lines": "ref_lines.cu",
    "intra_pred_all": "intra_pred.cu",
    "satd": "satd.cu",
    "transform_fwd": "transform.cu",
    "transform_inv": "transform.cu",
    "quant_rate": "quant_rate.cu",
    "mip_pred_all": "mip.cu",
    "lfnst_fwd": "lfnst.cu",
    "lfnst_inv": "lfnst.cu",
    "luma_ds": "cclm.cu",
    "cclm_models": "cclm.cu",
    "intra_pred_one": "intra_pred.cu",
    "sao_stats": "sao_stats.cu",
    "alf_stats": "alf_stats.cu",
    "me_prep": "me.cu",
    "me_coarse": "me.cu",
    "me_int": "me.cu",
    "me_qpel": "me.cu",
    "ref_lines_rect": "ref_lines.cu",
    "intra_pred_all_rect": "intra_pred.cu",
    "intra_pred_one_rect": "intra_pred.cu",
    "affine_search": "affine.cu",
    "affine_dctif": "affine.cu",
    "me_block_err": "me.cu",
    "wave_ref_lines": "ref_lines.cu",
    "dequant": "quant_rate.cu",
    "wave_cclm": "cclm.cu",
    "wave_commit": "wavefront.cu",
    "tile_edge_deblock": "deblock.cu",
    "interp_planes": "mc.cu",
    "phase_gather": "mc.cu",
    "block_dist": "satd.cu",
    "me_full": "me.cu",
    "affine_gn": "affine.cu",
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

COUNTS = {name: 0 for name in SOURCES}

_plain = contextvars.ContextVar("vvc_torch_plain", default=False)
_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def resolve_device(device=None) -> torch.device:
    """`None` means CUDA; raises when CUDA is absent.  Only an explicit
    ``"cpu"`` runs on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("vvc_torch: CUDA is not available; pass "
                           "device='cpu' to run on the CPU")
    return dev


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


@contextlib.contextmanager
def plain():
    """Run the plain PyTorch versions on CUDA tensors inside this block."""
    token = _plain.set(True)
    try:
        yield
    finally:
        _plain.reset(token)


def use_kernel(t: torch.Tensor) -> bool:
    """True when the wrapper must launch its CUDA kernel for tensor `t`."""
    return t.is_cuda and not _plain.get()


def _so_path(source: str) -> str:
    with open(os.path.join(CSRC, source), "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{digest.hexdigest()[:12]}.so")


def _nvcc() -> str:
    exe = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(exe):
        raise FileNotFoundError("vvc_torch: nvcc not found (CUDA toolkit "
                                "needed to build the kernels)")
    return exe


def build(verbose: bool = False) -> float:
    """Compile every kernel source not yet built; returns seconds spent.
    One nvcc process per source, all started together."""
    with _lock:
        t0 = time.perf_counter()
        todo = sorted(src for src in set(SOURCES.values())
                      if not os.path.exists(_so_path(src)))
        if not todo:
            return 0.0
        os.makedirs(BUILD_DIR, exist_ok=True)
        nvcc = _nvcc()
        procs = []
        for name in todo:
            out = _so_path(name)
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp,
                   os.path.join(CSRC, name)]
            procs.append((name, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for name, out, tmp, p in procs:
            log, _ = p.communicate()
            if p.returncode != 0:
                failed.append(f"{name}:\n{log}")
                continue
            os.replace(tmp, out)
            if verbose:
                print(f"[build] {name}: {log.strip()}")
        if failed:
            raise RuntimeError("vvc_torch: kernel build failed\n"
                               + "\n".join(failed))
        return time.perf_counter() - t0


def lib(name: str) -> ctypes.CDLL:
    """Load (building first if needed) the shared library of kernel `name`.
    Safe from several threads: the build and the load run under `_lock`
    (the lossy frame pool launches the filter statistics from 4 threads)."""
    src = SOURCES[name]
    if src not in _libs:
        build()
        with _lock:
            if src not in _libs:
                _libs[src] = ctypes.CDLL(_so_path(src))
    return _libs[src]


def launched(name: str, err: int) -> None:
    """Post-launch bookkeeping: raise on a launch error, else count it
    (under `_lock`: `+=` on a dict entry is not atomic across threads)."""
    if err != 0:
        raise RuntimeError(f"vvc_torch: kernel {name} launch failed "
                           f"(cudaError {err})")
    with _lock:
        COUNTS[name] += 1


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check_cuda_i32(name: str, *tensors: torch.Tensor) -> None:
    """Validate kernel inputs: CUDA, int32, contiguous, one device."""
    dev = tensors[0].device
    for t in tensors:
        if not (t.is_cuda and t.device == dev):
            raise ValueError(f"{name}: tensors must be on one CUDA device")
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: expected int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")

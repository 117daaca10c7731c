"""Build and load the package's CUDA kernels.

All ``csrc/*.cu`` files compile with one ``nvcc`` call into one shared
library with a plain C interface, which is loaded with ``ctypes``. The
library lands in ``audioldm2_torch/_build/`` and is keyed by a hash of the
sources and flags, so an edited source rebuilds and an unchanged one loads
the library already there. Nothing builds at import: the first kernel call
builds.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` turns a non-zero code into an exception, because a refused
launch never runs and a later synchronize does not report it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# argtypes of every C entry point: c_void_p for each pointer and the stream,
# so ctypes never narrows a 64-bit address to a 32-bit int.
SIGNATURES = {
    "a2k_gn_stats": [_P, _P, _I, _I, _I, _I, _I, _F, _P, _P, _P, _P, _I, _P],
    "a2k_gn_silu_conv3x3": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                            _P, _I, _I, _I, _P],
    "a2k_flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P],
    "a2k_ln_matmul": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P, _I, _I, _I, _P],
    "a2k_geglu_matmul": [_P, _P, _P, _P, _P, _I, _I, _I, _P, _I, _I, _I, _P],
}

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# GEMM core geometry (csrc/common.cuh) and its load-width flags
GEMM_BM, GEMM_BN, GEMM_BK = 64, 64, 32
GEMM_VEC_A, GEMM_VEC_B = 1, 2

_LIB: Optional[ctypes.CDLL] = None
BUILD_INFO: Dict[str, object] = {}


def find_nvcc() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, $PATH and /usr/local/cuda/bin); "
        "the CUDA kernels cannot be built"
    )


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")), sorted(CSRC_DIR.glob("*.cuh"))


def source_hash() -> str:
    cus, cuhs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in cus + cuhs:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels unless a library for these sources exists."""
    digest = source_hash()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD_DIR / f"libaudioldm2_kernels_{digest}.so"
    log_path = BUILD_DIR / f"build_{digest}.log"
    if lib_path.exists():
        BUILD_INFO.update(path=str(lib_path), seconds=0.0, cached=True,
                          log=log_path.read_text() if log_path.exists() else "")
        return lib_path
    nvcc = find_nvcc()
    cus, _ = _sources()
    tmp = BUILD_DIR / f".tmp_{digest}_{os.getpid()}.so"
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, cus)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
    log_path.write_text(log)
    os.replace(tmp, lib_path)  # atomic: a concurrent build never sees a partial file
    BUILD_INFO.update(path=str(lib_path), seconds=seconds, cached=False, log=log)
    return lib_path


def lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        handle.a2k_error_string.argtypes = [ctypes.c_int]
        handle.a2k_error_string.restype = ctypes.c_char_p
        _LIB = handle
    return _LIB


def check(rc: int, what: str) -> None:
    if rc != 0:
        msg = lib().a2k_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def dtype_code(t: torch.Tensor) -> int:
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"kernels take float32 or bfloat16, got {t.dtype}")
    return DTYPE_CODES[t.dtype]


def aligned16(*tensors) -> bool:
    return all(t is None or t.data_ptr() % 16 == 0 for t in tensors)


def gemm_launch_args(device, m: int, n: int, k: int, vec_a: bool, w: torch.Tensor):
    """(split-K workspace or None, k_split, vec flags) for the GEMM core.

    K is split over gridDim.z when the M x N output tiles fill fewer than
    two waves of the card's SMs (the small-M products of the UNet's deep
    levels), keeping at least four K tiles per split; the f32 partial sums
    go to a workspace allocated here and are reduced in a fixed order. The
    caller holds the returned workspace tensor over the launch."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    tiles = -(-m // GEMM_BM) * -(-n // GEMM_BN)
    ktiles = -(-k // GEMM_BK)
    splits = max(1, min(-(-2 * sms // tiles), ktiles // 4, 16))
    ws, k_split = None, k
    if splits > 1:
        k_split = -(-ktiles // splits) * GEMM_BK
        ws = torch.empty((-(-k // k_split), m, n), device=device, dtype=torch.float32)
    vec = (GEMM_VEC_A if vec_a else 0) | (GEMM_VEC_B if n % 8 == 0 and aligned16(w) else 0)
    return ws, k_split, vec


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Device, dtype and contiguity checks shared by every wrapper."""
    dev = tensors[0].device
    dt = tensors[0].dtype
    for t in tensors:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name}: all tensors must be on {dev}, got {t.device}")
        if t.dtype != dt:
            raise TypeError(f"{name}: mixed dtypes {dt} and {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    dtype_code(tensors[0])

"""Build and load the package's CUDA kernels.

Each ``csrc/*.cu`` file compiles to an object in its own ``nvcc``
process, all started together, and one more ``nvcc`` call links the
objects into one shared library with a plain C interface, which is loaded
with ``ctypes``. The
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
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, NamedTuple, Optional, Tuple

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong

# argtypes of every C entry point: c_void_p for each pointer and the stream,
# so ctypes never narrows a 64-bit address to a 32-bit int.
SIGNATURES = {
    "a2k_gn_stats": [_P, _P, _I, _I, _I, _I, _I, _F, _P, _P, _P, _P, _I, _P],
    "a2k_gn_silu_conv3x3": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                            _P, _I, _I, _I, _P],
    "a2k_flash_attention": [_P, _P, _P, _P, _L, _L, _L, _L, _L, _L, _I, _I, _I, _I, _F, _I, _P],
    "a2k_ln_matmul": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P, _I, _I, _I, _P],
    "a2k_ln_matmul_bf16": [_P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _F, _I, _I, _I, _I, _P],
    "a2k_geglu_matmul": [_P, _P, _P, _P, _P, _I, _I, _I, _P, _I, _I, _I, _P],
    "a2k_gn_silu_conv3x3_q": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                              _P, _I, _I, _I, _P],
    "a2k_ln_matmul_q": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P, _I, _I, _I, _P],
    "a2k_geglu_matmul_q": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _I, _I, _I, _P],
    "a2k_int8_matmul": [_P, _P, _P, _P, _P, _I, _I, _I, _P, _I, _I, _I, _P],
    "a2k_gn_apply": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "a2k_attention_variant": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _P],
}

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# GEMM core geometry (csrc/common.cuh) and its load-width flags
GEMM_BM, GEMM_BN, GEMM_BK = 64, 64, 32
GEMM_VEC_A, GEMM_VEC_B = 1, 2

# The bf16 K3 kernel's geometry (csrc/lnmm.cu): W tiles of LNMM_BK rows, rows
# padded by LNMM_PAD elements, (rows per block, N-tile width) pairs it is
# built for, and the dynamic shared memory one block may use on sm_90.
LNMM_BK, LNMM_PAD = 64, 8
LNMM_MAX_C = 768  # the widest row a lane of the kernel holds in registers for the LayerNorm
LNMM_TILES = ((128, 128), (64, 128), (64, 64))
LNMM_MAX_SMEM = 232448
LNMM_MAX_STAGES = 12
# Cost model of ln_matmul_plan, in units of one multiply-add of a (128, 128)
# tile (about 1.7e-3 clocks of one SM), fitted to the kernel's times on an
# H100 over every (rows, tile width, strip) choice at the 18 shapes the t5
# and large-1150k UNets give K3 (the plan's pick is then within 2% of the
# best measured choice at each): a smaller tile reuses each operand less; to
# fetch and normalize one element of the row block costs about 150; a block
# costs a fixed amount to start; a W tile that goes round the ring costs a
# wait and a barrier, which a strip that lies in the ring whole does not pay.
_LNMM_TILE_COST = {(128, 128): 1.0, (64, 128): 1.8, (64, 64): 2.0}
_LNMM_LN_COST = 150.0
_LNMM_BLOCK_COST = 1.0e6
_LNMM_RING_TILE_COST = 1.0e5
# A plan may leave up to this share of the SMs it could fill idle, and only
# for a grid of one wave: measured, one wave of long strips on 96 to 128 SMs
# beats a second, ragged wave of short ones by 25 to 35%.
LNMM_MIN_FILL = 0.7

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
    tag = f"{digest}_{os.getpid()}"
    tmp = BUILD_DIR / f".tmp_{tag}.so"
    objs = [BUILD_DIR / f".{cu.stem}_{tag}.o" for cu in cus]
    t0 = time.perf_counter()
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(cu)] for cu, o in zip(cus, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [proc.communicate()[0] for proc in procs]  # every process ends before any raise
    log = "".join(outs)
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
    cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log += proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
    for o in objs:
        o.unlink()
    seconds = time.perf_counter() - t0
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


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """The card's SM count, read once per device."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


class LnMatmulPlan(NamedTuple):
    """How the bf16 K3 kernel covers an [M, C] x [C, N] product: blocks of
    ``bm`` rows, each walking a strip of ``strip_tiles`` N tiles of width
    ``bn`` with its normalized rows in shared memory; W tiles of ``bk`` rows
    through a ring of ``stages``; grid (strips, row blocks)."""
    bm: int
    bn: int
    bk: int
    k_tiles: int       # ceil(C / bk); the kernel zero-fills A and W past C
    strip_tiles: int
    stages: int
    grid: Tuple[int, int]
    smem_bytes: int


@functools.lru_cache(maxsize=1024)
def ln_matmul_plan(m: int, c: int, n: int, sms: int) -> Optional[LnMatmulPlan]:
    """The launch plan of the bf16 K3 kernel for x [m, c] . w [c, n] on a
    card with ``sms`` SMs, or None for a shape it does not take (c or n not
    a multiple of 8, whose rows 16-byte copies cannot address, or c above
    LNMM_MAX_C); such shapes go to the shared GEMM core.

    Every (bm, bn) the kernel is built for and every strip length is a
    candidate if its grid fills the SMs the shape could fill, min(sms, row
    blocks x N tiles), or at least LNMM_MIN_FILL of them in a single wave.
    Among them the cheapest by a small model wins: a block costs its start,
    the LayerNorm of its rows, its tiles' multiply-adds and a barrier per W
    tile unless the ring holds its whole strip, and the grid runs in
    ceil(blocks / sms) waves. Long strips amortize the LayerNorm,
    short ones fill the card and even out the last wave. There is no
    split-K: the whole K = c lies in the block's shared memory."""
    if m < 1 or c < 8 or n < 8 or c % 8 or n % 8 or c > LNMM_MAX_C:
        return None
    k_tiles = -(-c // LNMM_BK)
    cp = k_tiles * LNMM_BK
    best, best_cost = None, None
    for bm, bn in LNMM_TILES:
        a_bytes = bm * (cp + LNMM_PAD) * 2
        stage_bytes = LNMM_BK * (bn + LNMM_PAD) * 2
        fit = (LNMM_MAX_SMEM - a_bytes) // stage_bytes
        if fit < 2:
            continue
        row_blocks, n_tiles = -(-m // bm), -(-n // bn)
        fill = min(sms, row_blocks * n_tiles)
        tile_cost = bm * bn * cp * _LNMM_TILE_COST[(bm, bn)]
        for strips in range(1, n_tiles + 1):
            strip_tiles = -(-n_tiles // strips)
            strips = -(-n_tiles // strip_tiles)  # no empty strip
            blocks = row_blocks * strips
            if blocks < fill and (blocks > sms or blocks < LNMM_MIN_FILL * fill):
                continue
            # the whole strip in the ring where it fits (the kernel then needs
            # one barrier for all of it), else four stages
            total = strip_tiles * k_tiles
            resident = total <= min(fit, LNMM_MAX_STAGES)
            stages = max(2, total if resident else min(fit, 4))
            cost = -(-blocks // sms) * (
                _LNMM_BLOCK_COST + bm * cp * _LNMM_LN_COST + strip_tiles * tile_cost
                + (0 if resident else total * _LNMM_RING_TILE_COST))
            if best_cost is None or cost < best_cost:
                best_cost = cost
                best = LnMatmulPlan(bm, bn, LNMM_BK, k_tiles, strip_tiles, stages,
                                    (strips, row_blocks), a_bytes + stages * stage_bytes)
    return best


def gemm_launch_args(device, m: int, n: int, k: int, vec_a: bool, w: torch.Tensor):
    """(split-K workspace or None, k_split, vec flags) for the GEMM core.

    K is split over gridDim.z when the M x N output tiles fill fewer than
    two waves of the card's SMs (the small-M products of the UNet's deep
    levels), keeping at least four K tiles per split; the f32 partial sums
    go to a workspace allocated here and are reduced in a fixed order. The
    caller holds the returned workspace tensor over the launch.

    The weight tile loads eight consecutive n at a time when N is a
    multiple of 8 and the weight pointer is aligned to those eight
    elements' load: 16 bytes for f32 (two float4) and bf16 (one uint4), 8
    bytes for int8 (one int2)."""
    sms = sm_count(torch.device(device).index or 0)
    tiles = -(-m // GEMM_BM) * -(-n // GEMM_BN)
    ktiles = -(-k // GEMM_BK)
    splits = max(1, min(-(-2 * sms // tiles), ktiles // 4, 16))
    ws, k_split = None, k
    if splits > 1:
        k_split = -(-ktiles // splits) * GEMM_BK
        ws = torch.empty((-(-k // k_split), m, n), device=device, dtype=torch.float32)
    vec_b = n % 8 == 0 and w.data_ptr() % min(16, 8 * w.element_size()) == 0
    vec = (GEMM_VEC_A if vec_a else 0) | (GEMM_VEC_B if vec_b else 0)
    return ws, k_split, vec


def require_int8(name: str, wq: torch.Tensor, ws: torch.Tensor, device) -> None:
    """An int8 weight (last dim N) and its f32 [N] scale, contiguous on ``device``."""
    for t in (wq, ws):
        if not t.is_cuda or t.device != device:
            raise ValueError(f"{name}: all tensors must be on {device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    if wq.dtype != torch.int8 or ws.dtype != torch.float32:
        raise TypeError(f"{name}: takes an int8 weight and an f32 scale, got {wq.dtype} "
                        f"and {ws.dtype}")
    if ws.shape != (wq.shape[-1],):
        raise ValueError(f"{name}: scale {tuple(ws.shape)} is not [{wq.shape[-1]}]")


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

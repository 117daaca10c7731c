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
import itertools
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
    "a2k_gn_stats": [_P, _P, _I, _I, _I, _I, _I, _F, _P, _P, _I, _P, _P, _P, _I, _P, _I, _P],
    "a2k_gn_silu_conv3x3_bf16": [_P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I,
                                 _I, _I, _I, _I, _I, _I, _I, _P],
    "a2k_gn_silu_conv3x3_q_bf16": [_P, _P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I,
                                   _I, _I, _I, _I, _I, _I, _I, _P],
    "a2k_gn_silu_conv3x3_f32": [_P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I,
                                _I, _I, _I, _I, _I, _I, _I, _P],
    "a2k_gn_silu_conv3x3": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                            _P, _I, _I, _I, _P],
    "a2k_conv2d_bf16": [_P, _P, _P, _P, _P, _P, _I, _P] + [_I] * 21 + [_P],
    "a2k_flash_attention": [_P, _P, _P, _P, _L, _L, _L, _L, _L, _L, _I, _I, _I, _I, _F, _I, _P],
    "a2k_ln_matmul": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P, _I, _I, _I, _P],
    "a2k_ln_matmul_bf16": [_P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _F, _I, _I, _I, _I, _P],
    "a2k_ln_matmul_q_bf16": [_P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _F, _I, _I, _I, _I,
                             _P],
    "a2k_geglu_matmul": [_P, _P, _P, _P, _P, _I, _I, _I, _P, _I, _I, _I, _P],
    "a2k_geglu_matmul_bf16": [_P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "a2k_geglu_matmul_bf16_f32res": [_P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "a2k_geglu_matmul_q_bf16": [_P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "a2k_geglu_matmul_q_bf16_f32res": [_P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                       _I, _P],
    "a2k_int8_matmul_bf16": [_P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "a2k_int8_matmul_bf16_f32out": [_P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "a2k_gn_silu_conv3x3_q": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                              _P, _I, _I, _I, _P],
    "a2k_ln_matmul_q": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P, _I, _I, _I, _P],
    "a2k_geglu_matmul_q": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _I, _I, _I, _P],
    "a2k_int8_matmul": [_P, _P, _P, _P, _P, _I, _I, _I, _P, _I, _I, _I, _P],
    "a2k_group_norm_silu": [_P, _P, _P, _I, _P, _I, _I, _I, _I, _F, _I, _I, _I, _I, _I, _I, _P,
                            _P, _I, _P],
    "a2k_group_norm_silu_occupancy": [_I, _I, _I, _P],
    "a2k_attention_variant": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _P],
}

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# GEMM core geometry (csrc/common.cuh) and its load-width flags
GEMM_BM, GEMM_BN, GEMM_BK = 64, 64, 32
GEMM_VEC_A, GEMM_VEC_B = 1, 2

# The bf16 row-block kernel's geometry (csrc/lnmm.cu, K3 and K4): W tiles of
# LNMM_BK rows, rows padded by LNMM_PAD elements, the (rows per block,
# N-tile width) pairs it is built for, and the dynamic shared memory one
# block may use on sm_90.
LNMM_BK, LNMM_PAD = 64, 8
LNMM_MAX_C = 768  # the widest row a lane of the kernel holds in registers for the LayerNorm
LNMM_MAX_SMEM = 232448
LNMM_MAX_STAGES = 12
GEGLU_STAGES = 6  # K4's ring where it does not hold the whole strip
GEGLU_MAX_SPLITS = 8  # K4's K split over a portable thread-block cluster
# Cost model of ln_matmul_plan, in units of one multiply-add of a (128, 128)
# tile (about 1.7e-3 clocks of one SM), fitted to the kernel's times on an
# H100 over every (rows, tile width, strip) choice at the 18 shapes the t5
# and large-1150k UNets give K3 (the plan's pick is then within 2% of the
# best measured choice at each): a smaller tile reuses each operand less; to
# fetch and normalize one element of the row block costs about 150; a block
# costs a fixed amount to start; a W tile that goes round the ring costs a
# wait and a barrier, which a strip that lies in the ring whole does not pay.
_LNMM_TILE_COST = {(128, 128): 1.0, (64, 128): 1.8, (64, 64): 2.0}
LNMM_TILES = tuple(_LNMM_TILE_COST)  # (rows per block, N-tile width) K3 is built for
_LNMM_LN_COST = 150.0
# K4's plan: the same model over its own tiles, with the gate product's cost
# (two loads and an erff an element) in place of the LayerNorm's; fitted
# to tools/tune_k1_k4.py's sweep on an H100 (see PERF.md).
_GEGLU_TILE_COST = {(64, 128): 1.8, (64, 64): 2.2, (32, 128): 4.0, (32, 64): 5.0,
                    (16, 128): 11.0, (16, 64): 5.5}
GEGLU_TILES = tuple(_GEGLU_TILE_COST)  # ... K4 is built for
_GEGLU_COST = 380.0
_GEGLU_RED_COST = 500.0  # one f32 element of a tile summed over the cluster
_GEGLU_RING_COST = 5.0e5  # a W tile's wait, shared by the stages in flight
_GEGLU_SM_SHARE = 0.85
# K4's and K1's plans count the blocks an SM holds at once (shared memory,
# and registers from ptxas of their kernels at 256 threads): a wave of
# `occ` co-resident blocks takes (1 + (occ - 1) * share) times one block's
# cost, since they overlap each other's waits but share the units.
SM_SMEM = 233472  # shared memory of one SM; each block also reserves 1 KB
_GEGLU_REGS = {(64, 128): 120, (64, 64): 120, (32, 128): 120, (32, 64): 121, (16, 128): 121,
               (16, 64): 121}
_CONV_REGS = {(256, 64): 152, (128, 128): 152, (64, 128): 100, (64, 64): 80}
_CONV_Q_REGS = {(256, 64): 159, (128, 128): 162, (64, 128): 118, (64, 64): 74}  # K1q's


def blocks_per_sm(smem: int, regs: int, threads: int = 256) -> int:
    """Blocks of ``threads`` one SM holds at once, by shared memory and
    registers (at least one)."""
    return max(1, min(SM_SMEM // (smem + 1024), 65536 // (threads * regs), 2048 // threads))


def _waves_cost(blocks: int, sms: int, occ: int, block_cost: float, share: float) -> float:
    """A grid of ``blocks`` in waves of sms x occ, each wave as one block
    slowed by each co-resident other by ``share`` of its cost."""
    return -(-blocks // (sms * occ)) * block_cost * (1 + (occ - 1) * share)
_LNMM_BLOCK_COST = 1.0e6
_LNMM_RING_TILE_COST = 1.0e5
# K3q and K1q (int8 weights on the same kernels): a ring row of an int8 W
# tile is padded by LNMM_Q_PAD bytes and two bf16 staging tiles sit beside
# the ring. K3q's plan: converting one int8 W element into a staging tile
# costs _Q_CVT_COST, with the barrier each tile then needs even in a resident
# ring; the ring runs LNMMQ_RING_STAGES deep where it does not hold the
# strip. It is within 1% of the fastest choice tools/tune_k1_k4.py --only
# k3q measured, over a full8 forward's calls (see PERF.md).
LNMM_Q_PAD = 16
LNMMQ_RING_STAGES = 6
_Q_CVT_COST = 10.0
_Q_TILE_BARRIER_COST = 1.0e5
# K4q and K5 (int8 weights on K4's tiles, K5 with a copy for its pass):
# K4's model with K3q's conversion and barrier cost a W tile, on tile costs
# of their own; registers from ptxas of their instantiations. The tile
# costs were fitted offline to tools/tune_k1_k4.py --only k5|k4q on an H100
# (each kernel's forward weighted by its calls): the plans then pick the
# fastest measured choice at five of the six full8 shapes and one 4% off it
# at the sixth (see PERF.md).
_GEGLU_Q_REGS = {(64, 128): 118, (64, 64): 116, (32, 128): 119, (32, 64): 117, (16, 128): 117,
                 (16, 64): 121}
_K5_REGS = {(64, 128): 96, (64, 64): 60, (32, 128): 48, (32, 64): 75, (16, 128): 63,
            (16, 64): 64}
_K5_TILE_COST = {(64, 128): 1.8, (64, 64): 0.22, (32, 128): 4.0, (32, 64): 0.6, (16, 128): 11.0,
                 (16, 64): 5.5}
_GEGLU_Q_TILE_COST = {(64, 128): 0.18, (64, 64): 2.2, (32, 128): 4.0, (32, 64): 5.0,
                      (16, 128): 11.0, (16, 64): 5.5}
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
    grid: Tuple[int, int]  # (strips, row blocks); times ``splits`` in z
    smem_bytes: int
    splits: int = 1    # K4: K split over a cluster of this many blocks


@functools.lru_cache(maxsize=1024)
def ln_matmul_plan(m: int, c: int, n: int, sms: int, w_bytes: int = 2) -> Optional[LnMatmulPlan]:
    """The launch plan of the bf16 K3 kernel for x [m, c] . w [c, n] on a
    card with ``sms`` SMs, or None for a shape it does not take (c or n not
    a multiple of 8, whose rows 16-byte copies cannot address, or c above
    LNMM_MAX_C); such shapes go to the shared GEMM core.

    ``w_bytes`` 1: K3q's plan, an int8 w on the same kernel (n a multiple of
    16): the ring's tiles take half the bytes beside two bf16 staging tiles
    (``row_block_smem``), a ring that does not hold the strip runs
    LNMMQ_RING_STAGES deep, and every W tile costs its conversion and a
    barrier.

    Every (bm, bn) the kernel is built for and every strip length is a
    candidate if its grid fills the SMs the shape could fill, min(sms, row
    blocks x N tiles), or at least LNMM_MIN_FILL of them in a single wave.
    Among them the cheapest by a small model wins: a block costs its start,
    the LayerNorm of its rows, its tiles' multiply-adds and a barrier per W
    tile unless the ring holds its whole strip, and the grid runs in
    ceil(blocks / sms) waves. Long strips amortize the LayerNorm,
    short ones fill the card and even out the last wave. There is no
    split-K: the whole K = c lies in the block's shared memory."""
    if c > LNMM_MAX_C:
        return None
    if w_bytes == 1:
        if n % 16:
            return None
        return _row_block_plan(m, c, n, sms, _LNMM_TILE_COST, _LNMM_LN_COST,
                               ring_stages=LNMMQ_RING_STAGES, w_bytes=1)
    return _row_block_plan(m, c, n, sms, _LNMM_TILE_COST, _LNMM_LN_COST)


def row_block_smem(bm: int, bn: int, a_cols: int, stages: int, w_bytes: int = 2,
                   splits: int = 1) -> int:
    """Shared memory of one block of the row-block kernel: the A tile [bm,
    a_cols] in bf16 and the ring of ``stages`` W tiles (int8, K3q: two bf16
    staging tiles beside a ring of int8 tiles); a split's f32 tile [bm,
    bn + 4] reuses the same memory."""
    a_bytes = bm * (a_cols + LNMM_PAD) * 2
    if w_bytes == 1:
        ring = 2 * LNMM_BK * (bn + LNMM_PAD) * 2 + stages * LNMM_BK * (bn + LNMM_Q_PAD)
    else:
        ring = stages * LNMM_BK * (bn + LNMM_PAD) * 2
    return max(a_bytes + ring, bm * (bn + 4) * 4 if splits > 1 else 0)


@functools.lru_cache(maxsize=1024)
def geglu_matmul_plan(m: int, f: int, n: int, sms: int, dtype: str = "bf16",
                      w_bytes: int = 2) -> Optional[LnMatmulPlan]:
    """The launch plan of the bf16 K4 kernel for h [m, 2f] -> u [m, f],
    u . w [f, n], on K3's row-block kernel: the block forms its rows' gate
    product once into shared memory ([bm, f] bf16, which at f = 2560 leaves
    room for 32 rows or fewer) and walks a strip of N tiles; or, split over
    a cluster of up to GEGLU_MAX_SPLITS blocks, each forms and multiplies
    its share of K for one N tile and the cluster sums the shares through
    distributed shared memory (no workspace, no second launch). The same
    candidates, fill rule (counting the splits) and model as ln_matmul_plan,
    with the blocks an SM holds at once, over GEGLU_TILES (rows per block
    64, 32 or 16)
    with the gate product's cost in place of the LayerNorm's. None for what
    the kernel does not take: f32, f or n not a multiple of 8, or a row
    block that leaves no room for two W tiles.

    ``w_bytes`` 1: K4q's plan, an int8 w on the same kernel (n a multiple of
    16): two bf16 staging tiles beside an int8 ring (``row_block_smem``) and
    each W tile's conversion and barrier counted, as in K3q's plan."""
    if dtype != "bf16":
        return None
    if w_bytes == 1:
        if n % 16:
            return None
        return _row_block_plan(m, f, n, sms, _GEGLU_Q_TILE_COST, _GEGLU_COST, _GEGLU_Q_REGS,
                               LNMMQ_RING_STAGES, GEGLU_MAX_SPLITS, w_bytes=1)
    return _row_block_plan(m, f, n, sms, _GEGLU_TILE_COST, _GEGLU_COST, _GEGLU_REGS,
                           GEGLU_STAGES, GEGLU_MAX_SPLITS)


@functools.lru_cache(maxsize=1024)
def int8_matmul_plan(m: int, k: int, n: int, sms: int,
                     dtype: str = "bf16") -> Optional[LnMatmulPlan]:
    """The launch plan of the bf16 K5 kernel for x [m, k] . wq [k, n], an
    int8 weight, on the row-block kernel with K4q's tiles, int8 ring and
    cluster split: the block copies its rows of x (its share of k) into
    shared memory as they are, with no pass to pay for. The same
    candidates, fill rule and model as geglu_matmul_plan(..., w_bytes=1).
    None for what the kernel does not take: f32, k not a multiple of 8, n
    not a multiple of 16, or a row block that leaves no room for two W
    tiles; the wrapper sends those to the shared GEMM core."""
    if dtype != "bf16" or n % 16:
        return None
    return _row_block_plan(m, k, n, sms, _K5_TILE_COST, 0.0, _K5_REGS, LNMMQ_RING_STAGES,
                           GEGLU_MAX_SPLITS, w_bytes=1)


def _row_block_plan(m, c, n, sms, tile_costs, pass_cost, regs=None, ring_stages=4,
                    max_splits=1, w_bytes=2) -> Optional[LnMatmulPlan]:
    """The candidates and model of ln_matmul_plan (regs None: one block per
    SM, four ring stages, no split; w_bytes 1, K3q: int8 W tiles converted
    into staging tiles) and of geglu_matmul_plan and int8_matmul_plan (regs:
    blocks_per_sm, up to ``ring_stages``, K split over a cluster of up to
    ``max_splits`` blocks, each holding only its share of A; w_bytes 1, K4q
    and K5); ``tile_costs`` maps each (bm, bn) the kernel is built for to
    its cost per multiply-add."""
    if m < 1 or c < 8 or n < 8 or c % 8 or n % 8:
        return None
    k_tiles = -(-c // LNMM_BK)
    q = w_bytes == 1
    best, best_cost = None, None
    for bm, bn in tile_costs:
        row_blocks, n_tiles = -(-m // bm), -(-n // bn)
        fill = min(sms, row_blocks * n_tiles * min(max_splits, k_tiles))
        for want in range(1, min(max_splits, k_tiles) + 1):
            kps = -(-k_tiles // want)  # K tiles a block takes
            splits = -(-k_tiles // kps)  # no empty split
            if splits != want:
                continue
            cp = kps * LNMM_BK
            a_bytes = row_block_smem(bm, bn, cp, 0, w_bytes)
            stage_bytes = row_block_smem(bm, bn, cp, 1, w_bytes) - a_bytes
            fit = (LNMM_MAX_SMEM - a_bytes) // stage_bytes
            if fit < 2:
                continue
            tile_cost = bm * bn * cp * tile_costs[(bm, bn)]
            for strips in range(1, n_tiles + 1) if splits == 1 else (n_tiles,):
                strip_tiles = -(-n_tiles // strips)
                strips = -(-n_tiles // strip_tiles)  # no empty strip
                blocks = row_blocks * strips * splits
                if blocks < fill and (blocks > sms or blocks < LNMM_MIN_FILL * fill):
                    continue
                # the whole strip in the ring where it fits (the kernel then needs
                # one barrier for all of it), else four stages (K3) or, for K4,
                # two, three or ring_stages (fewer stages let more blocks share
                # an SM)
                total = strip_tiles * kps
                resident = total <= min(fit, LNMM_MAX_STAGES)
                if resident:
                    depths = (max(2, total),)
                elif regs is None:
                    depths = (min(fit, ring_stages),)
                else:
                    depths = sorted({2, min(fit, 3), min(fit, ring_stages)})
                # int8: each W tile's conversion and the barrier its staging needs
                cvt = total * (LNMM_BK * bn * _Q_CVT_COST + _Q_TILE_BARRIER_COST) if q else 0
                for stages in depths:
                    smem = row_block_smem(bm, bn, cp, stages, w_bytes, splits)
                    if regs is None:
                        block_cost = (_LNMM_BLOCK_COST + bm * cp * pass_cost
                                      + strip_tiles * tile_cost + cvt
                                      + (0 if resident else total * _LNMM_RING_TILE_COST))
                        cost = -(-blocks // sms) * block_cost
                    else:
                        block_cost = (_LNMM_BLOCK_COST + bm * cp * pass_cost
                                      + strip_tiles * tile_cost + cvt
                                      + (0 if resident else
                                         total * _GEGLU_RING_COST / (stages - 1))
                                      + (bm * bn * splits * _GEGLU_RED_COST if splits > 1
                                         else 0))
                        occ = blocks_per_sm(smem, regs[(bm, bn)])
                        cost = _waves_cost(blocks, sms, occ, block_cost, _GEGLU_SM_SHARE)
                    if best_cost is None or cost < best_cost:
                        best_cost = cost
                        best = LnMatmulPlan(bm, bn, LNMM_BK, k_tiles, strip_tiles, stages,
                                            (strips, row_blocks), smem, splits)
    return best


# The bf16 K1 kernel's geometry (csrc/gn_silu_conv.cu): chunks of CONV_CK
# input channels (one tap's W tile is [CONV_CK, BN]), patch rows of CONV_LD
# elements, W rows padded by CONV_PAD, the (rows per block, N-tile width)
# pairs it is built for, the deepest ring (a chunk's patch buffer is reused
# two chunks later) and the widest split (a portable thread-block cluster).
CONV_CK, CONV_LD, CONV_PAD = 64, 72, 8
CONV_STAGES, CONV_MAX_STAGES, CONV_MAX_SPLITS = (2, 3, 4, 6, 8), 8, 8
# K1's plan, the same model: a chunk costs its patch's activation, its nine
# tiles' multiply-adds and ring waits; a split costs the cluster's sum.
# Fitted to tools/tune_k1_k4.py's sweep on an H100 (see PERF.md).
_CONV_TILE_COST = {(256, 64): 1.05, (128, 128): 1.0, (64, 128): 5.0, (64, 64): 1.25}
CONV_TILES = tuple(_CONV_TILE_COST)  # ... K1 is built for
_CONV_BLOCK_COST = 4.5e6
_CONV_ACT_COST = 1100.0  # one element of the patch activated
_CONV_RED_COST = 200.0   # one f32 element of a tile summed over the cluster
_CONV_RING_COST = 2.5e6  # a W tile's wait, shared by the stages in flight
_CONV_SM_SHARE = 0.16


class _ConvModel(NamedTuple):
    tile_cost: Dict[Tuple[int, int], float]
    block: float
    act: float
    ring: float
    red: float
    share: float
    regs: Dict[Tuple[int, int], int]


_CONV_MODEL = _ConvModel(_CONV_TILE_COST, _CONV_BLOCK_COST, _CONV_ACT_COST, _CONV_RING_COST,
                         _CONV_RED_COST, _CONV_SM_SHARE, _CONV_REGS)
# K1q's model: the same terms on the same tiles, fitted apart to
# tools/tune_k1_k4.py --only k1q on an H100 (see PERF.md): a deeper int8 ring
# buys nothing measurable (its slots free a step early), co-resident blocks
# overlap each other more, and the tiles' costs per multiply-add (with the
# conversion pass) differ
_CONV_Q_MODEL = _ConvModel({(256, 64): 1.05, (128, 128): 0.8, (64, 128): 1.3, (64, 64): 1.6},
                           _CONV_BLOCK_COST, _CONV_ACT_COST, 0.0, _CONV_RED_COST, 0.5,
                           _CONV_Q_REGS)


# The f32 K1 (the same kernel, 3xTF32 on the tensor cores): chunks of
# CONV32_CK channels, the activated patch and the weight's staging tiles in
# two planes (hi, lo) of rows of CONV32_LD f32 words, one tile,
# CONV32_TILE, with CONV32_THREADS threads: tools/tune_k1_k4.py --only
# k1f32 on an H100 timed it fastest at every shape of the encode, its only
# traffic (see PERF.md). Its own constants (three products a multiply-add,
# an expf and a split an element of the patch; registers from ptxas), set
# against the same sweep.
CONV32_CK, CONV32_LD = 32, 36
CONV32_TILE = (256, 64)
CONV32_THREADS = 512
_CONV_F32_MODEL = _ConvModel({CONV32_TILE: 3.2}, _CONV_BLOCK_COST, 2500.0, 1.5e6,
                             _CONV_RED_COST, _CONV_SM_SHARE, {CONV32_TILE: 112})


# The plain conv's plan (K1's bf16 kernel with its geometry at run time):
# K1's model with the tiles' costs, the activation's, the ring's wait and the
# co-resident blocks' overlap refitted to tools/time_conv2d.py --sweep on an
# H100 over its 54 UNet shapes of audioldm2-full and audioldm_48k (the picks
# then within 0.5% and 3.3% of the best measured per forward; see PERF.md);
# registers from ptxas of its instantiations at 256 threads.
_CONV2D_MODEL = _CONV_MODEL._replace(
    tile_cost={(256, 64): 1.05, (128, 128): 1.0, (64, 128): 1.4, (64, 64): 1.6}, act=500.0,
    ring=2.0e5, share=0.3, regs={(256, 64): 207, (128, 128): 207, (64, 128): 150, (64, 64): 108})


class ConvPlan(NamedTuple):
    """How the bf16 K1 kernel covers a [B, T, F, Cin] -> Cout conv: blocks
    of tt x ft output positions of one sample (at most ``bm`` rows of the
    product), each walking a strip of ``strip_tiles`` Cout tiles of width
    ``bn``, the input channels in ``k_chunks`` chunks of ``ck``, each
    chunk's nine taps' W tiles through a ring of ``stages``; with
    ``splits`` > 1 the chunks are split over a cluster of that many blocks.
    Grid (strips, B x T tiles x F tiles, splits)."""
    bm: int
    bn: int
    tt: int
    ft: int
    ck: int
    k_chunks: int
    strip_tiles: int
    stages: int
    splits: int
    grid: Tuple[int, int, int]
    smem_bytes: int


def conv_patch(tt: int, ft: int, taps: int = 3, stride: int = 1) -> int:
    """Positions of the patch that a tile of tt x ft outputs reads: (tt + 2)
    x (ft + 2) for K1's 3x3 (csrc ConvGeo::patch)."""
    return ((tt - 1) * stride + taps) * ((ft - 1) * stride + taps)


def conv_smem_bytes(bm: int, bn: int, tt: int, ft: int, stages: int, w_bytes: int = 2,
                    taps: int = 3, stride: int = 1) -> int:
    """Two patch buffers (``conv_patch``), the chunk's a and c (two
    buffers) and the W ring (``w_bytes`` 1, K1q: two bf16 staging tiles and a
    ring of int8 tiles whose rows are padded by LNMM_Q_PAD bytes); the split
    epilogue's f32 tile [bm, bn + 4] reuses the same memory."""
    if w_bytes == 1:
        ring = 2 * CONV_CK * (bn + CONV_PAD) * 2 + stages * CONV_CK * (bn + LNMM_Q_PAD)
    else:
        ring = stages * CONV_CK * (bn + CONV_PAD) * 2
    main = 2 * conv_patch(tt, ft, taps, stride) * CONV_LD * 2 + 4 * CONV_CK * 4 + ring
    return max(main, bm * (bn + 4) * 4)


def conv32_smem_bytes(bm: int, bn: int, tt: int, ft: int, stages: int) -> int:
    """The f32 kernel's block: the raw patch [P, CONV32_CK], its activation
    in two planes [P, CONV32_LD], the chunk's a and c, a ring of raw W tiles
    [CONV32_CK, bn + 4] and two staging tiles of the split weight in two
    planes [bn, CONV32_LD] (P = (tt + 2) x (ft + 2)); the split epilogue's
    f32 tile [bm, bn + 4] reuses the same memory."""
    p = (tt + 2) * (ft + 2)
    main = (p * CONV32_CK * 4 + 2 * p * CONV32_LD * 4 + 2 * CONV32_CK * 4
            + stages * CONV32_CK * (bn + 4) * 4 + 4 * bn * CONV32_LD * 4)
    return max(main, bm * (bn + 4) * 4)


@functools.lru_cache(maxsize=1024)
def gn_silu_conv_plan(b: int, t: int, f: int, cin: int, cout: int, sms: int,
                      dtype: str = "bf16", w_bytes: int = 2) -> Optional[ConvPlan]:
    """The launch plan of the K1 kernel, or None for what it does not take
    (Cin or Cout not a multiple of 8); the wrapper sends those, and
    unaligned pointers or concat parts no multiple of 8, to the shared GEMM
    core. ``w_bytes`` 1: K1q's plan, an int8 weight on the same kernel
    (Cout a multiple of 16; bf16 only), its ring's tiles half the bytes
    beside two bf16 staging tiles (``conv_smem_bytes``), under its own
    constants (``_CONV_Q_MODEL``). ``dtype`` "f32": the f32 kernel (3xTF32),
    chunks of CONV32_CK channels, ``conv32_smem_bytes``, its own constants
    (``_CONV_F32_MODEL``).

    A block's tile is ft = min(F, bm) positions wide in F and as many rows
    of T as fit in bm (at most T); in f32, where that patch does not fit
    the shared memory at the shallowest ring (F of 128 and more: the 48 kHz
    VAE encode), ft halves until it does. Candidates: each (bm, bn), each split of
    the chunks over a cluster of up to CONV_MAX_SPLITS blocks, and without a
    split each strip length; kept if the grid fills the SMs the shape could
    fill, min(sms, tiles x min(CONV_MAX_SPLITS, chunks)), or at least
    LNMM_MIN_FILL of them in one wave. The cheapest by K3's model wins: a
    block costs its start, per chunk of its strip the patch's activation,
    nine tiles' multiply-adds and nine ring waits, and with a split the
    cluster's reduction; the grid runs in waves of the blocks the SMs hold
    at once (_waves_cost)."""
    f32 = dtype == "f32"
    if ((dtype != "bf16" and not (f32 and w_bytes == 2)) or min(b, t, f) < 1 or cin < 8
            or cout < 8 or cin % 8 or cout % (16 if w_bytes == 1 else 8)):
        return None
    model = _CONV_F32_MODEL if f32 else _CONV_Q_MODEL if w_bytes == 1 else _CONV_MODEL
    return _conv_plan(b, t, f, cin, cout, sms, model, f32, w_bytes)


def conv2d_takes(taps: int, stride: int, cin: int, cout: int) -> bool:
    """What the plain conv kernel takes: a ``taps`` x ``taps`` conv (1 or 3)
    at ``stride`` (1 or 2) over Cin channels onto Cout, both multiples of 8
    (``nn.conv2d_uses_kernel`` adds what the call's layout must show)."""
    return (taps in (1, 3) and stride in (1, 2) and cin >= 8 and cout >= 8 and cin % 8 == 0
            and cout % 8 == 0)


@functools.lru_cache(maxsize=1024)
def conv2d_plan(b: int, t: int, f: int, cin: int, cout: int, sms: int, taps: int = 3,
                stride: int = 1) -> Optional[ConvPlan]:
    """The launch plan of the plain conv on K1's bf16 kernel
    (``a2k_conv2d_bf16``): a [B, t, f, Cout] output (t, f the output's
    extent) of a ``taps`` x ``taps`` conv at ``stride`` over Cin channels,
    or None for what ``conv2d_takes`` declines. The cheapest of
    ``conv2d_candidates``."""
    cands = conv2d_candidates(b, t, f, cin, cout, sms, taps, stride)
    return min(cands, key=lambda cp: cp[0])[1] if cands else None


def conv2d_candidates(b: int, t: int, f: int, cin: int, cout: int, sms: int, taps: int = 3,
                      stride: int = 1):
    """[(cost, ConvPlan)] that conv2d_plan chooses among (tools.time_conv2d
    --sweep times each): K1's search under ``_CONV2D_MODEL``, where a tile
    of tt x ft outputs reads a patch of ``conv_patch(tt, ft, taps, stride)``
    positions, and where two of them do not fit beside the shallowest ring
    (a stride-2 tile as tall as K1's) tt halves, then ft, until they do; the
    ring is at most taps^2 + 1 deep (a chunk's patch lands with the W tile
    issued at the chunk before it, one chunk of taps^2 tiles earlier: a 1x1
    conv keeps two stages)."""
    if min(b, t, f) < 1 or not conv2d_takes(taps, stride, cin, cout):
        return []
    return list(_conv_candidates(b, t, f, cin, cout, sms, _CONV2D_MODEL, False, 2, taps, stride,
                                 True))


def _conv_plan(b, t, f, cin, cout, sms, model, f32, w_bytes):
    """gn_silu_conv_plan's search: the cheapest of _conv_candidates (the
    first of equal costs)."""
    cands = _conv_candidates(b, t, f, cin, cout, sms, model, f32, w_bytes)
    best = min(cands, key=lambda cp: cp[0], default=None)
    return None if best is None else best[1]


def _conv_candidates(b, t, f, cin, cout, sms, model, f32, w_bytes, taps=3, stride=1,
                     plain=False):
    """(cost, ConvPlan) of every launch the search of gn_silu_conv_plan and,
    with ``plain``, conv2d_plan weighs: each tile and ring depth that fits,
    each split that leaves no block empty, the strips whose grid fills the
    SMs."""
    ck = CONV32_CK if f32 else CONV_CK
    k_chunks = -(-cin // ck)
    stage_choices = [s for s in CONV_STAGES if s <= taps * taps + 1]
    # the widest split with no empty block (10 chunks split 5 ways at most)
    most_splits = max(-(-k_chunks // -(-k_chunks // w))
                      for w in range(1, min(CONV_MAX_SPLITS, k_chunks) + 1))
    for (bm, bn), stages in itertools.product((CONV32_TILE,) if f32 else CONV_TILES,
                                              stage_choices):
        ft = min(f, bm)
        tt = min(bm // ft, t)
        while f32 and ft > 8 and conv32_smem_bytes(bm, bn, tt, ft,
                                                   min(CONV_STAGES)) > LNMM_MAX_SMEM:
            ft //= 2
            tt = min(bm // ft, t)
        while plain and tt * ft > 1 and conv_smem_bytes(
                bm, bn, tt, ft, min(stage_choices), 2, taps, stride) > LNMM_MAX_SMEM:
            tt, ft = (-(-tt // 2), ft) if tt > 1 else (tt, -(-ft // 2))
        smem = (conv32_smem_bytes(bm, bn, tt, ft, stages) if f32
                else conv_smem_bytes(bm, bn, tt, ft, stages, w_bytes, taps, stride))
        if smem > LNMM_MAX_SMEM:
            continue
        m_tiles = b * -(-t // tt) * -(-f // ft)
        n_tiles = -(-cout // bn)
        occ = blocks_per_sm(smem, model.regs[(bm, bn)], CONV32_THREADS if f32 else 256)
        fill = min(sms, m_tiles * n_tiles * (most_splits if plain else
                                             min(CONV_MAX_SPLITS, k_chunks)))
        chunk_cost = (conv_patch(tt, ft, taps, stride) * ck * model.act
                      + taps * taps * bm * bn * ck * model.tile_cost[(bm, bn)]
                      + taps * taps * model.ring / (stages - 1))
        for want in range(1, min(CONV_MAX_SPLITS, k_chunks) + 1):
            cps = -(-k_chunks // want)
            splits = -(-k_chunks // cps)  # no empty split
            for strips in range(1, n_tiles + 1) if splits == 1 else (n_tiles,):
                strip_tiles = -(-n_tiles // strips)
                strips = -(-n_tiles // strip_tiles)
                blocks = m_tiles * strips * splits
                if blocks < fill and (blocks > sms or blocks < LNMM_MIN_FILL * fill):
                    continue
                block_cost = (model.block + strip_tiles * cps * chunk_cost
                              + (bm * bn * splits * model.red if splits > 1 else 0))
                yield (_waves_cost(blocks, sms, occ, block_cost, model.share),
                       ConvPlan(bm, bn, tt, ft, ck, k_chunks, strip_tiles, stages, splits,
                                (strips, m_tiles, splits), smem))


GN_STATS_THREADS = 256
GN_STATS_ROWS_PER_THREAD = 8  # rows each thread of a statistics block holds (ST_ROWS)


def gn_stats_chunks(s: int, cin: int) -> int:
    """Row chunks per sample of the GroupNorm statistics pass: a block's
    threads cover its rows in row lanes of eight channels each (as many
    lanes as fit a row into GN_STATS_THREADS), and every thread holds
    GN_STATS_ROWS_PER_THREAD rows in registers; so more chunks where the
    rows are narrow or many (512 for the VAE's 65,536 rows of 128 channels),
    few where they are few; the grid is chunks x batch. The last block of
    a sample combines them."""
    lanes = max(1, GN_STATS_THREADS // -(-cin // 8))
    rows = max(1, min(s, GN_STATS_ROWS_PER_THREAD * lanes))
    return -(-s // rows)


GN_COUNTER_SLOTS = 1 << 16  # samples one statistics launch can take


@functools.lru_cache(maxsize=None)
def gn_counter(device_index: int, stream: int) -> torch.Tensor:
    """The statistics pass's per-sample arrival counters for the launches on
    one stream of one device: allocated and zeroed once, left zeroed by
    every launch (the last block of each sample resets its own)."""
    return torch.zeros(GN_COUNTER_SLOTS, dtype=torch.int32,
                       device=torch.device("cuda", device_index))


# K6 (csrc/groupnorm.cu: a2k_group_norm_silu): one cooperative launch of at
# most one block of GN_THREADS per SM, the blocks of a sample splitting its
# rows.
GN_THREADS = 512
GN_MAX_SMEM = 232448
GN_PARTIAL_FLOATS = 1 << 20  # the per-block partial sums one launch can write
# Bytes of x below which a block is not worth its share of the barrier and
# the combine: tools/tune_k1_k4.py --only k6 on an H100 timed the t5 UNet's
# out_norm (1 MB a sample) at 14.9 us on 66 blocks a sample and 13.0 on 32
# (PERF.md).
GN_BLOCK_BYTES = 32768


class GroupNormPlan(NamedTuple):
    """How K6 covers x [B, S, C]: ``blocks_per_sample`` blocks per sample,
    each taking ``rows`` consecutive rows (the last may take fewer, none
    takes none), the last ``rows_held`` of them in shared memory: all of
    them (``resident``: x read once), or as many as fit, the rows before
    them read from device memory for the statistics and again for the
    output. ``slots`` samples at a time (all of them unless B is above the
    SM count), each block taking its part of samples slot, slot + slots,
    ... in turn. Grid: slots x blocks_per_sample."""
    resident: bool
    blocks_per_sample: int
    rows: int
    rows_held: int
    slots: int
    grid: int
    smem_bytes: int


def gn_silu_smem_bytes(rows_held: int, c: int, groups: int, esize: int, vec: bool) -> int:
    """K6's block (``gnsilu_smem_bytes``): the slab of rows_held rows
    (16-byte rounded), the running (n, mean, M2) per group in double, the
    per-thread channel sums [row lanes, C], the chunk's group means and M2s,
    and the affine [2, C]."""
    cp = c // 8 if vec else c
    rp = 1 if cp >= GN_THREADS else GN_THREADS // cp
    slab = -(-rows_held * c * esize // 16) * 16
    return slab + groups * 3 * 8 + rp * c * 4 + 2 * groups * 4 + 2 * c * 4


@functools.lru_cache(maxsize=1024)
def group_norm_silu_plan(b: int, s: int, c: int, dtype: str, sms: int, groups: int = 32,
                         vec: bool = True) -> Optional[GroupNormPlan]:
    """K6's launch plan for x [b, s, c] in ``dtype`` ("bf16" or "f32") on a
    card of ``sms`` SMs: at most one block per SM, floor(sms / b) per
    sample (one where b is above sms, the samples then taken sms at a time),
    fewer where a block would hold less than GN_BLOCK_BYTES of x or no row,
    each a contiguous run of rows. The run stays in shared memory when it
    fits (``resident``; on 132 SMs up to about 29 MB of x in all), else its
    last rows stay, as many as fit, and the rest are read again for the
    output. The cooperative launch needs the whole grid resident: the
    wrapper holds the grid to what cudaOccupancyMaxActiveBlocksPerMulti-
    processor allows at the plan's shared memory (``gn_silu_occupancy``).
    None where one row does not fit."""
    if min(b, s, c, groups, sms) < 1 or c % groups:
        return None
    esize = 2 if dtype == "bf16" else 4
    nb = max(1, min(sms // b, -(-s * c * esize // GN_BLOCK_BYTES)))
    rows = -(-s // nb)
    nb = -(-s // rows)  # no empty block
    slots = min(b, sms // nb)
    smem = gn_silu_smem_bytes(rows, c, groups, esize, vec)
    if smem <= GN_MAX_SMEM:
        return GroupNormPlan(True, nb, rows, rows, slots, slots * nb, smem)
    fixed = gn_silu_smem_bytes(0, c, groups, esize, vec)
    held = (GN_MAX_SMEM - fixed) // (c * esize)
    if held < 1:
        return None
    return GroupNormPlan(False, nb, rows, held, slots, slots * nb,
                         gn_silu_smem_bytes(held, c, groups, esize, vec))


@functools.lru_cache(maxsize=None)
def gn_silu_occupancy(device_index: int, dtype_code: int, vec: bool, smem: int) -> int:
    """Blocks of K6 one SM of the device holds at once with ``smem`` bytes
    of shared memory, read once per (device, instantiation, size)."""
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        check(lib().a2k_group_norm_silu_occupancy(dtype_code, int(vec), smem,
                                                  ctypes.addressof(blocks)),
              "a2k_group_norm_silu_occupancy")
    return blocks.value


@functools.lru_cache(maxsize=None)
def gn_barrier(device_index: int, stream: int) -> torch.Tensor:
    """K6's per-sample barrier words for the launches on one stream of one
    device (arrivals, left zero by every launch; a generation word each):
    zeroed once. Launches on two streams never share them."""
    return torch.zeros(2 * GN_COUNTER_SLOTS, dtype=torch.int32,
                       device=torch.device("cuda", device_index))


@functools.lru_cache(maxsize=None)
def gn_partials(device_index: int, stream: int) -> torch.Tensor:
    """K6's scratch for each block's (mean, M2) per group, reused by the
    launches on one stream of one device (each after the last, in stream
    order)."""
    return torch.empty(GN_PARTIAL_FLOATS, dtype=torch.float32,
                       device=torch.device("cuda", device_index))


def params_as_stored(dev, *params):
    """Parameters (None allowed) as a kernel that reads f32 or bf16 takes
    them: as they are when all are contiguous bf16 on ``dev`` (the cast
    parameter tree's own leaves: no conversion kernels before the launch),
    else as f32 copies. Returns (tensors, param dtype code: 1 bf16, 0 f32)."""
    given = [p for p in params if p is not None]
    if all(p.dtype == torch.bfloat16 and p.device == dev and p.is_contiguous() for p in given):
        return params, 1
    return tuple(None if p is None else p.to(dev, torch.float32).contiguous()
                 for p in params), 0


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

"""Ops of the port: plain PyTorch ops and the Hopper kernel wrappers."""

from __future__ import annotations

from typing import Dict


def kernel_wrappers():
    """name -> wrapper of every hand-written kernel, in K1..K4 order."""
    from audioldm2_torch.ops import attention_kernel, lnmm_kernel, resblock_kernel

    return {
        "gn_silu_conv3x3": resblock_kernel.gn_silu_conv3x3,
        "flash_self_attention": attention_kernel.flash_self_attention,
        "ln_matmul": lnmm_kernel.ln_matmul,
        "geglu_matmul": lnmm_kernel.geglu_matmul,
    }


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def reset_launch_counts() -> None:
    for fn in kernel_wrappers().values():
        fn.launches = 0

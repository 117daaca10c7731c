"""Ops of the port: plain PyTorch ops and the Hopper kernel wrappers."""

from __future__ import annotations

from typing import Dict


KERNEL_NAMES = ("gn_silu_conv3x3", "flash_self_attention", "ln_matmul", "geglu_matmul",
                "gn_silu_conv3x3_q", "int8_matmul", "ln_matmul_q", "geglu_matmul_q",
                "group_norm_silu", "v6bd_attention", "v7_attention")


def kernel_wrappers():
    """name -> wrapper of every hand-written kernel, in KERNEL_NAMES order
    (K1..K4, the int8 kernels K1q, K5, K3q, K4q, then K6, K7 and K8)."""
    from audioldm2_torch.ops import attention_kernel, attention_variants_kernel as avk
    from audioldm2_torch.ops import groupnorm_kernel, lnmm_kernel
    from audioldm2_torch.ops import resblock_kernel

    return {
        "gn_silu_conv3x3": resblock_kernel.gn_silu_conv3x3,
        "flash_self_attention": attention_kernel.flash_self_attention,
        "ln_matmul": lnmm_kernel.ln_matmul,
        "geglu_matmul": lnmm_kernel.geglu_matmul,
        "gn_silu_conv3x3_q": resblock_kernel.gn_silu_conv3x3_q,
        "int8_matmul": lnmm_kernel.int8_matmul,
        "ln_matmul_q": lnmm_kernel.ln_matmul_q,
        "geglu_matmul_q": lnmm_kernel.geglu_matmul_q,
        "group_norm_silu": groupnorm_kernel.group_norm_silu,
        "v6bd_attention": avk.v6bd_attention,
        "v7_attention": avk.v7_attention,
    }


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def reset_launch_counts() -> None:
    for fn in kernel_wrappers().values():
        fn.launches = 0

"""Ops of the port: plain PyTorch ops and the Hopper kernel wrappers."""

from __future__ import annotations

from typing import Dict


KERNEL_NAMES = ("gn_silu_conv3x3", "flash_self_attention", "ln_matmul", "geglu_matmul",
                "gn_silu_conv3x3_q", "int8_matmul", "ln_matmul_q", "geglu_matmul_q",
                "group_norm_silu", "v6bd_attention", "v7_attention", "conv2d")


def kernel_wrappers():
    """name -> wrapper of every hand-written kernel, in KERNEL_NAMES order
    (K1..K4, the int8 kernels K1q, K5, K3q, K4q, then K6, K7, K8 and the
    plain conv on K1's kernel)."""
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
        "conv2d": resblock_kernel.conv2d,
    }


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def declined_counts() -> Dict[str, int]:
    """bf16 CUDA calls that a kernel's dispatch rule declined: "conv2d", the
    conv2d calls (``nn.conv2d_uses_kernel``) left to the f32-copy path."""
    from audioldm2_torch.ops import resblock_kernel

    return {"conv2d": resblock_kernel.conv2d.declined}


def add_counts(launches: Dict[str, int], declined: Dict[str, int], times: int = 1) -> None:
    """Add ``times`` x the given launch and declined counts (a CUDA graph's
    replay adds the launches that its capture recorded)."""
    from audioldm2_torch.ops import resblock_kernel

    wrappers = kernel_wrappers()
    for name, n in launches.items():
        wrappers[name].launches += times * n
    resblock_kernel.conv2d.declined += times * declined["conv2d"]


def reset_launch_counts() -> None:
    """Zero every launch count and the declined counts."""
    from audioldm2_torch.ops import resblock_kernel

    for fn in kernel_wrappers().values():
        fn.launches = 0
    resblock_kernel.conv2d.declined = 0

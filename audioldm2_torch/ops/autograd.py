"""Autograd through the hand kernels: forward on the kernel, backward by
recomputing the plain version.

The port's counterpart of ``audioldm2_tpu/ops/nn.py:429-521``
(``_gn_silu_conv_fused`` with ``jax.custom_vjp``, whose backward
``_gn_silu_conv_bwd`` is ``jax.vjp`` of the plain composition on the saved
inputs). A kernel wrapper fills a ``torch.empty`` through raw pointers, so
its output has no ``grad_fn``: without this a CUDA forward under
``loss.backward()`` would leave every weight that only the kernel reads
without a gradient, and say nothing.

:class:`KernelFunction` runs the kernel wrapper in its forward (grad mode
is off there, so the wrapper launches its kernel) and saves the tensor
inputs; its backward runs the kernel's ``*_plain`` version on them under
``torch.enable_grad()`` and returns ``torch.autograd.grad`` of it for every
tensor input that needs one. No kernel has a backward kernel of its own,
as no Pallas function of the JAX package has.
"""

from __future__ import annotations

from typing import Callable

import torch


def needs_grad(*tensors) -> bool:
    """Whether a call on ``tensors`` (None allowed) must be recorded for
    autograd: grad mode on and a tensor that requires grad."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


class KernelFunction(torch.autograd.Function):
    """apply(kernel, plain, *args): kernel(*args) in the forward; in the
    backward, the gradients of plain(*args) on the saved inputs. ``args``
    mixes tensors, None and Python scalars, as the wrappers take them."""

    @staticmethod
    def forward(ctx, kernel: Callable, plain: Callable, *args):
        ctx.plain = plain
        ctx.tensor_at = [i for i, a in enumerate(args) if isinstance(a, torch.Tensor)]
        ctx.args = [None if isinstance(a, torch.Tensor) else a for a in args]
        ctx.save_for_backward(*(args[i] for i in ctx.tensor_at))
        return kernel(*args)

    @staticmethod
    def backward(ctx, grad):
        args = list(ctx.args)
        needs = ctx.needs_input_grad[2:]
        wrt = []
        for i, t in zip(ctx.tensor_at, ctx.saved_tensors):
            args[i] = t.detach().requires_grad_(needs[i])
            if needs[i]:
                wrt.append(i)
        grads = [None] * len(args)
        if wrt:
            with torch.enable_grad():
                out = ctx.plain(*args)
                got = torch.autograd.grad(out, [args[i] for i in wrt], grad)
            for i, g in zip(wrt, got):
                grads[i] = g
        return (None, None, *grads)


def refuse_grad(name: str) -> None:
    """The int8 serving kernels have no gradient (their Pallas versions
    have no VJP, and the serving mode is not trained)."""
    raise RuntimeError(
        f"{name}: the int8 serving kernel has no gradient; train on the unquantized "
        "weights (f32 or bf16), or call it under torch.no_grad()")

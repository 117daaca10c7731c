"""The collectives of the dp x tp mesh, and the tensor-parallel products
that the UNet and T5 call under a mesh.

JAX's GSPMD inserts these for the sharded program; the port calls them by
hand, as Megatron does:
- ``copy_to_tp`` ("f") before a column-parallel product on a replicated
  input: identity forward, all-reduce of the gradient over tp backward;
- ``reduce_from_tp`` ("g") after a row-parallel product: all-reduce over
  tp forward, identity backward (each tp rank then holds the whole
  gradient of the replicated output). ``torch.distributed.nn.functional.
  all_reduce`` is not used for it: its backward all-reduces the gradient
  again, which counts a loss that every tp rank computes tp times;
- ``all_gather`` over dp for the waveforms, and ``mean_over_dp`` for the
  gradients.

The model code runs under ``tensor_parallel(mesh)``, which names the mesh
whose tp group these use; outside it (or at tp 1) every tp function is the
single-device op, so a tp 1 run is the unsharded program.

gloo has no all_gather for CUDA tensors, so with gloo every collective on
a CUDA tensor is staged through pinned host memory (``_staged``): copied to
the host, reduced or gathered there, copied back. NCCL takes them on the
card. No collective falls back from one backend to the other.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional

import torch
import torch.nn.functional as F

from audioldm2_torch.ops import autograd, lnmm_kernel, nn

_ACTIVE = None  # the Mesh the model code runs under (tensor_parallel)


@contextlib.contextmanager
def tensor_parallel(mesh):
    """Run the model code inside the block on ``mesh``'s tp slices."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, (mesh if mesh is not None and mesh.tp > 1 else None)
    try:
        yield
    finally:
        _ACTIVE = prev


def tp_size() -> int:
    return _ACTIVE.tp if _ACTIVE is not None else 1


def tp_rank() -> int:
    return _ACTIVE.tp_rank if _ACTIVE is not None else 0


def _staged(x: torch.Tensor, mesh) -> bool:
    return mesh.backend == "gloo" and x.is_cuda


def _to_host(x: torch.Tensor) -> torch.Tensor:
    h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    h.copy_(x)
    return h


def all_reduce(x: torch.Tensor, mesh, group, op: str = "sum") -> torch.Tensor:
    """The sum (``op="max"``: the elementwise max) of ``x`` over
    ``group``'s ranks, as a new tensor."""
    import torch.distributed as dist

    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    if _staged(x, mesh):
        h = _to_host(x)
        dist.all_reduce(h, op=red, group=group)
        return h.to(x.device, non_blocking=False)
    y = x.clone()
    dist.all_reduce(y, op=red, group=group)
    return y


def all_gather(x: torch.Tensor, mesh, group, size: int) -> List[torch.Tensor]:
    """``x`` of every rank of ``group`` (``size`` ranks), in rank order."""
    import torch.distributed as dist

    src = _to_host(x) if _staged(x, mesh) else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(size)]
    dist.all_gather(parts, src, group=group)
    return [p.to(x.device) for p in parts]


def all_gather_dp(x: torch.Tensor, mesh) -> torch.Tensor:
    """The dp ranks' rows concatenated in dp order (the waveforms)."""
    if mesh.dp == 1:
        return x
    return torch.cat(all_gather(x, mesh, mesh.dp_group, mesh.dp), dim=0)


def mean_over_dp(tensors, mesh) -> None:
    """Replace each tensor (the gradients) by its mean over the dp ranks,
    in one all-reduce of their f32 concatenation."""
    tensors = [t for t in tensors if t is not None]
    if mesh.dp == 1 or not tensors:
        return
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    flat = all_reduce(flat, mesh, mesh.dp_group) / mesh.dp
    at = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[at:at + n].view_as(t))
        at += n


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.mesh = _ACTIVE
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, ctx.mesh, ctx.mesh.tp_group)


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return all_reduce(x, _ACTIVE, _ACTIVE.tp_group)

    @staticmethod
    def backward(ctx, grad):
        return grad


def copy_to_tp(x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """Megatron's "f": ``x`` itself, with its gradient all-reduced over tp
    when autograd records the call."""
    if _ACTIVE is None or x is None or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _CopyToTP.apply(x)


def max_over_tp(x: torch.Tensor) -> torch.Tensor:
    """The elementwise max of ``x`` over tp (no autograd; ``x`` itself
    outside ``tensor_parallel``): the int8 quantization's column absmax of
    a row-split weight, all of a call's leaves in one concatenation."""
    if _ACTIVE is None:
        return x
    return all_reduce(x, _ACTIVE, _ACTIVE.tp_group, op="max")


def reduce_from_tp(x: torch.Tensor) -> torch.Tensor:
    """Megatron's "g": the sum of ``x`` over tp (identity backward)."""
    if _ACTIVE is None:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _ReduceFromTP.apply(x)
    return all_reduce(x, _ACTIVE, _ACTIVE.tp_group)


# ---------------------------------------------------------------------------
# The tensor-parallel products
# ---------------------------------------------------------------------------


def row_parallel_linear(p, x: torch.Tensor) -> torch.Tensor:
    """``nn.linear(p, x)`` with ``p["w"]`` (or the int8 ``p["wq"]``, whose
    scale ``p["ws"]`` is the whole weight's) split by rows over tp and
    ``x`` the matching columns: each rank's x @ w in f32 (int8: K5 in its
    f32-output mode, * ws), summed over tp, plus the bias (added after the
    sum, on every rank), one rounding to x.dtype."""
    if _ACTIVE is None:
        return nn.linear(p, x)
    if "wq" in p:
        part = lnmm_kernel.int8_matmul(x, p["wq"], p["ws"], None, out_dtype=torch.float32)
        y = all_reduce(part, _ACTIVE, _ACTIVE.tp_group)  # the int8 kernels refuse autograd
    else:
        y = reduce_from_tp(F.linear(x.float(), p["w"].float().t()))
    if p.get("b") is not None:
        y = y + p["b"].float()
    return y.to(x.dtype)


def _geglu_partial_sum(h, w, bias, residual, ws=None):
    """The tp sum of K4 (K4q with the int8 ``w`` and its whole-weight scale
    ``ws``) on this rank's [a_r | gate_r] and w rows, bias and residual
    added by tp rank 0 only, in f32 (the f32-residual mode), one rounding
    to residual.dtype after the sum."""
    first = tp_rank() == 0
    b = bias if first else torch.zeros_like(bias)
    r = residual.float() if first else torch.zeros(residual.shape, device=residual.device)
    if ws is None:
        part = lnmm_kernel.geglu_matmul(h, w, b, r)
    else:
        part = lnmm_kernel.geglu_matmul_q(h, w, ws, b, r)
    return all_reduce(part, _ACTIVE, _ACTIVE.tp_group).to(residual.dtype)


class _RowParallelGeglu(torch.autograd.Function):
    """residual + sum over tp of (a_r * gelu(g_r)) @ w_r + bias. Backward:
    the gradients of this rank's product by the plain version; the bias and
    the residual, which are whole on every rank, take the whole gradient on
    every rank."""

    @staticmethod
    def forward(ctx, h, w, bias, residual):
        ctx.save_for_backward(h, w)
        ctx.dtypes = (bias.dtype, residual.dtype)
        return _geglu_partial_sum(h, w, bias, residual)

    @staticmethod
    def backward(ctx, grad):
        h, w = ctx.saved_tensors
        g = grad.float()
        gh = gw = gb = gr = None
        need_h, need_w, need_b, need_r = ctx.needs_input_grad
        if need_h or need_w:
            with torch.enable_grad():
                hh, ww = h.detach().requires_grad_(need_h), w.detach().requires_grad_(need_w)
                zero_b = torch.zeros(w.shape[1], device=w.device)
                zero_r = torch.zeros(grad.shape, device=grad.device)
                out = lnmm_kernel.geglu_matmul_plain(hh, ww, zero_b, zero_r)
                wrt = [t for t, need in ((hh, need_h), (ww, need_w)) if need]
                got = list(torch.autograd.grad(out, wrt, g))
            gh = got.pop(0) if need_h else None
            gw = got.pop(0) if need_w else None
        if need_b:
            gb = g.reshape(-1, g.shape[-1]).sum(0).to(ctx.dtypes[0])
        if need_r:
            gr = grad.to(ctx.dtypes[1])
        return gh, gw, gb, gr


def row_parallel_geglu(p_lin, h: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
    """``nn.geglu_ff_out(p_lin, h, residual)`` with h = [a_r | gate_r] this
    rank's GEGLU columns and ``p_lin["w"]`` (or the int8 ``p_lin["wq"]``
    with the whole weight's ``p_lin["ws"]``) its rows: K4 (K4q) per rank in
    its f32-residual mode, the bias and the residual added by one rank,
    summed over tp in f32, rounded once."""
    if _ACTIVE is None:
        return nn.geglu_ff_out(p_lin, h, residual)
    if "wq" in p_lin:  # the int8 kernels refuse autograd
        return _geglu_partial_sum(h, p_lin["wq"], p_lin["b"], residual, p_lin["ws"])
    if autograd.needs_grad(h, p_lin["w"], p_lin["b"], residual):
        return _RowParallelGeglu.apply(h, p_lin["w"], p_lin["b"], residual)
    return _geglu_partial_sum(h, p_lin["w"], p_lin["b"], residual)

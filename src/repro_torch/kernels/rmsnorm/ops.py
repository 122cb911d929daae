"""Public norm ops: the Triton kernel for a CUDA tensor, the plain version
for a CPU tensor.

Both are differentiable: where grad mode is on and an input requires a
gradient, ``rmsnorm`` runs as ``RMSNormFn`` and ``layernorm`` as
``LayerNormFn``, whose forwards are the same ops and whose backwards are
``rmsnorm_bwd_triton`` and ``layernorm_bwd`` (the ring kernel of
``csrc/layernorm_bwd.cu``, or ``layernorm_bwd_triton`` for rows it does not
take) on the card and ``rmsnorm_bwd_ref`` and ``layernorm_bwd_ref`` on the
CPU. Otherwise (serving) each calls its forward directly and builds no
graph."""
from __future__ import annotations

import torch

from ...device import runs_plain
from .kernel import layernorm_bwd, layernorm_triton, rmsnorm_bwd_triton, rmsnorm_triton
from .ref import layernorm_bwd_ref, layernorm_ref, rmsnorm_bwd_ref, rmsnorm_ref


def _rmsnorm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    if runs_plain(x):
        return rmsnorm_ref(x, g, eps)
    return rmsnorm_triton(x, g, eps)


class RMSNormFn(torch.autograd.Function):
    """RMSNorm over rows with its hand-written backward."""

    @staticmethod
    def forward(ctx, x, g, eps):
        ctx.save_for_backward(x, g)
        ctx.eps = eps
        return _rmsnorm(x, g, eps)

    @staticmethod
    def backward(ctx, dy):
        x, g = ctx.saved_tensors
        if dy.stride(-1) != 1:
            dy = dy.contiguous()
        if runs_plain(x):
            dx, dg = rmsnorm_bwd_ref(x, g, dy, ctx.eps)
        else:
            dx, dg = rmsnorm_bwd_triton(x, g, dy, ctx.eps)
        return dx, dg, None


def rmsnorm(x: torch.Tensor, g: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """x: (R, C); g: (C,)."""
    if torch.is_grad_enabled() and (x.requires_grad or g.requires_grad):
        return RMSNormFn.apply(x, g, eps)
    return _rmsnorm(x, g, eps)


def _layernorm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    if runs_plain(x):
        return layernorm_ref(x, g, b, eps)
    return layernorm_triton(x, g, b, eps)


class LayerNormFn(torch.autograd.Function):
    """LayerNorm over rows with its hand-written backward."""

    @staticmethod
    def forward(ctx, x, g, b, eps):
        ctx.save_for_backward(x, g)
        ctx.eps = eps
        ctx.b_dtype = b.dtype
        return _layernorm(x, g, b, eps)

    @staticmethod
    def backward(ctx, dy):
        x, g = ctx.saved_tensors
        if dy.stride(-1) != 1:
            dy = dy.contiguous()
        if runs_plain(x):
            dx, dg, db = layernorm_bwd_ref(x, g, dy, ctx.eps)
        else:
            dx, dg, db = layernorm_bwd(x, g, dy, ctx.eps)
        return dx, dg, db.to(ctx.b_dtype), None


def layernorm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, *,
              eps: float = 1e-5) -> torch.Tensor:
    """x: (R, C); g, b: (C,)."""
    if torch.is_grad_enabled() and (x.requires_grad or g.requires_grad or b.requires_grad):
        return LayerNormFn.apply(x, g, b, eps)
    return _layernorm(x, g, b, eps)

"""Public activation ops: the kernel (CUDA C++ for GELU and gated GELU,
Triton for the SwiGLU gate) for a CUDA tensor, the plain version for a CPU
tensor.

Each is differentiable: where grad mode is on and an input requires a
gradient, ``gelu`` runs as ``GeluFn``, ``gelu_mul`` as ``GeluMulFn`` and
``silu_mul`` as ``SiluMulFn``, whose forwards are the same ops and whose
backwards are ``gelu_bwd_cuda``, ``gelu_mul_bwd_cuda`` and
``silu_mul_bwd_triton`` on the card and their plain versions
(``gelu_bwd_ref``, ``gelu_mul_bwd_ref``, ``silu_mul_bwd_ref``) on the CPU.
Otherwise (serving) each calls its forward directly and builds no graph."""
from __future__ import annotations

import torch

from ...device import runs_plain
from .kernel import (gelu_bwd_cuda, gelu_cuda, gelu_mul_bwd_cuda, gelu_mul_cuda,
                     silu_mul_bwd_triton, silu_mul_triton)
from .ref import (gelu_bwd_ref, gelu_mul_bwd_ref, gelu_mul_ref, gelu_ref, silu_mul_bwd_ref,
                  silu_mul_ref)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    if runs_plain(x):
        return gelu_ref(x)
    return gelu_cuda(x)


class GeluFn(torch.autograd.Function):
    """The tanh-GELU with its hand-written backward."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _gelu(x)

    @staticmethod
    def backward(ctx, dy):
        x, = ctx.saved_tensors
        dy = dy.contiguous()
        if runs_plain(x):
            return gelu_bwd_ref(x, dy)
        return gelu_bwd_cuda(x, dy)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximation GELU, computed in fp32, one rounding."""
    if torch.is_grad_enabled() and x.requires_grad:
        return GeluFn.apply(x)
    return _gelu(x)


def _silu_mul(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    if runs_plain(g):
        return silu_mul_ref(g, u)
    return silu_mul_triton(g, u)


class SiluMulFn(torch.autograd.Function):
    """The SwiGLU gate with its hand-written backward."""

    @staticmethod
    def forward(ctx, g, u):
        ctx.save_for_backward(g, u)
        return _silu_mul(g, u)

    @staticmethod
    def backward(ctx, dy):
        g, u = ctx.saved_tensors
        dy = dy.contiguous()
        if runs_plain(g):
            return silu_mul_bwd_ref(g, u, dy)
        return silu_mul_bwd_triton(g, u, dy)


def silu_mul(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """silu(g) * u, computed in fp32, one rounding."""
    if torch.is_grad_enabled() and (g.requires_grad or u.requires_grad):
        return SiluMulFn.apply(g, u)
    return _silu_mul(g, u)


def _gelu_mul(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    if runs_plain(g):
        return gelu_mul_ref(g, u)
    return gelu_mul_cuda(g, u)


class GeluMulFn(torch.autograd.Function):
    """The gated GELU with its hand-written backward."""

    @staticmethod
    def forward(ctx, g, u):
        ctx.save_for_backward(g, u)
        return _gelu_mul(g, u)

    @staticmethod
    def backward(ctx, dy):
        g, u = ctx.saved_tensors
        dy = dy.contiguous()
        if runs_plain(g):
            return gelu_mul_bwd_ref(g, u, dy)
        return gelu_mul_bwd_cuda(g, u, dy)


def gelu_mul(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """gelu(g) * u (tanh approximation), computed in fp32, one rounding."""
    if torch.is_grad_enabled() and (g.requires_grad or u.requires_grad):
        return GeluMulFn.apply(g, u)
    return _gelu_mul(g, u)

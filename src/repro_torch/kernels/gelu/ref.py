"""Plain PyTorch tanh-GELU, gated GELU and SwiGLU gate, in the layout of ``repro.kernels.gelu``."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def gelu_ref(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximation GELU in fp32, rounded once to x's dtype."""
    return F.gelu(x.float(), approximate="tanh").to(x.dtype)


def silu_mul_ref(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """silu(g) * u in fp32, rounded once to g's dtype."""
    return (F.silu(g.float()) * u.float()).to(g.dtype)


def gelu_mul_ref(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """tanh-approximation gelu(g) * u in fp32, rounded once to g's dtype."""
    return (F.gelu(g.float(), approximate="tanh") * u.float()).to(g.dtype)


def silu_mul_bwd_ref(g: torch.Tensor, u: torch.Tensor, dy: torch.Tensor):
    """Gradients of ``silu_mul_ref`` for the output gradient dy, as an
    explicit formula in fp32, each rounded once to g's dtype:
    ``dg = dy * u * s * (1 + g * (1 - s))`` with ``s = sigmoid(g)``, and
    ``du = dy * g * s``."""
    gf, uf, dyf = g.float(), u.float(), dy.float()
    s = torch.sigmoid(gf)
    dg = dyf * uf * s * (1 + gf * (1 - s))
    return dg.to(g.dtype), (dyf * gf * s).to(g.dtype)


_K = math.sqrt(2.0 / math.pi)
_A = 0.044715


def _gelu_grad(x: torch.Tensor) -> torch.Tensor:
    """d/dx of the tanh-GELU ``x * sigmoid(2 z)``, z = K (x + A x^3), in
    fp32: ``s + x * 2 K (1 + 3 A x^2) * s * (1 - s)`` with s = sigmoid(2 z)
    and 1 - s = sigmoid(-2 z), neither of which cancels. x is clamped to
    [-20, 20], past which the fp32 derivative is exactly 0 and 1, so that
    x^3 cannot overflow into inf * 0."""
    x = x.float().clamp(-20.0, 20.0)
    z2 = 2 * _K * (x + _A * x * x * x)
    return torch.sigmoid(z2) + x * (2 * _K * (1 + 3 * _A * x * x)) * (
        torch.sigmoid(z2) * torch.sigmoid(-z2))


def gelu_bwd_ref(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Gradient of ``gelu_ref`` for the output gradient dy: ``dy *
    gelu'(x)`` in fp32, rounded once to x's dtype."""
    return (dy.float() * _gelu_grad(x)).to(x.dtype)


def gelu_mul_bwd_ref(g: torch.Tensor, u: torch.Tensor, dy: torch.Tensor):
    """Gradients of ``gelu_mul_ref`` for the output gradient dy, in fp32,
    each rounded once to g's dtype: ``dg = dy * u * gelu'(g)`` and ``du =
    dy * gelu(g)``."""
    dyf = dy.float()
    dg = dyf * u.float() * _gelu_grad(g)
    return dg.to(g.dtype), (dyf * F.gelu(g.float(), approximate="tanh")).to(g.dtype)

"""Plain PyTorch RMSNorm and LayerNorm, in the layout of ``repro.kernels.rmsnorm``."""
from __future__ import annotations

import torch


def rmsnorm_ref(x: torch.Tensor, g: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x: (R, C); g: (C,). fp32 statistics, output in x's dtype."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * g.float()).to(x.dtype)


def layernorm_ref(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """x: (R, C); g, b: (C,). fp32 mean and biased variance, output in x's
    dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * g.float() + b.float()).to(x.dtype)


def rmsnorm_bwd_ref(x: torch.Tensor, g: torch.Tensor, dy: torch.Tensor,
                    eps: float = 1e-6):
    """Gradients of ``rmsnorm_ref`` at x (R, C), g (C,) for the output
    gradient dy (R, C), as an explicit formula in fp32: with
    ``xh = x * rsqrt(var + eps)`` and ``w = g * dy``,
    ``dx = (w - xh * mean(w * xh)) * rsqrt(var + eps)`` rounded once to x's
    dtype, and ``dg = sum_rows(dy * xh)`` in g's dtype."""
    xf, dyf = x.float(), dy.float()
    rstd = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    xh = xf * rstd
    w = dyf * g.float()
    dx = (w - xh * (w * xh).mean(-1, keepdim=True)) * rstd
    return dx.to(x.dtype), (dyf * xh).sum(0).to(g.dtype)


def layernorm_bwd_ref(x: torch.Tensor, g: torch.Tensor, dy: torch.Tensor,
                      eps: float = 1e-5):
    """Gradients of ``layernorm_ref`` at x (R, C), g (C,) for the output
    gradient dy (R, C), as an explicit formula in fp32: with
    ``xh = (x - mean) * rsqrt(var + eps)`` (the biased variance) and
    ``w = g * dy``, ``dx = (w - mean(w) - xh * mean(w * xh)) * rsqrt(var +
    eps)`` rounded once to x's dtype, ``dg = sum_rows(dy * xh)`` and ``db =
    sum_rows(dy)`` in g's dtype."""
    xf, dyf = x.float(), dy.float()
    xc = xf - xf.mean(-1, keepdim=True)
    rstd = torch.rsqrt(xc.square().mean(-1, keepdim=True) + eps)
    xh = xc * rstd
    w = dyf * g.float()
    dx = (w - w.mean(-1, keepdim=True) - xh * (w * xh).mean(-1, keepdim=True)) * rstd
    return dx.to(x.dtype), (dyf * xh).sum(0).to(g.dtype), dyf.sum(0).to(g.dtype)

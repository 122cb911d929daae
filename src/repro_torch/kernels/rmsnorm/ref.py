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

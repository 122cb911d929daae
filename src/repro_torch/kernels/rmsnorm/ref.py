"""Plain PyTorch RMSNorm, in the layout of ``repro.kernels.rmsnorm``."""
from __future__ import annotations

import torch


def rmsnorm_ref(x: torch.Tensor, g: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x: (R, C); g: (C,). fp32 statistics, output in x's dtype."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * g.float()).to(x.dtype)

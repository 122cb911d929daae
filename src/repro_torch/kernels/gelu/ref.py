"""Plain PyTorch SwiGLU gate, in the layout of ``repro.kernels.gelu``."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def silu_mul_ref(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """silu(g) * u in fp32, rounded once to g's dtype."""
    return (F.silu(g.float()) * u.float()).to(g.dtype)

"""Plain PyTorch tanh-GELU, gated GELU and SwiGLU gate, in the layout of ``repro.kernels.gelu``."""
from __future__ import annotations

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

"""Public activation ops: the kernel (CUDA C++ for GELU and gated GELU,
Triton for the SwiGLU gate) for a CUDA tensor, the plain version for a CPU
tensor."""
from __future__ import annotations

import torch

from ...device import runs_plain
from .kernel import gelu_cuda, gelu_mul_cuda, silu_mul_triton
from .ref import gelu_mul_ref, gelu_ref, silu_mul_ref


def gelu(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximation GELU, computed in fp32, one rounding."""
    if runs_plain(x):
        return gelu_ref(x)
    return gelu_cuda(x)


def silu_mul(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """silu(g) * u, computed in fp32, one rounding."""
    if runs_plain(g):
        return silu_mul_ref(g, u)
    return silu_mul_triton(g, u)


def gelu_mul(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """gelu(g) * u (tanh approximation), computed in fp32, one rounding."""
    if runs_plain(g):
        return gelu_mul_ref(g, u)
    return gelu_mul_cuda(g, u)

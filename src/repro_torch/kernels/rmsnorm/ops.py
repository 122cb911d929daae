"""Public norm ops: the Triton kernel for a CUDA tensor, the plain version
for a CPU tensor."""
from __future__ import annotations

import torch

from ...device import runs_plain
from .kernel import layernorm_triton, rmsnorm_triton
from .ref import layernorm_ref, rmsnorm_ref


def rmsnorm(x: torch.Tensor, g: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """x: (R, C); g: (C,)."""
    if runs_plain(x):
        return rmsnorm_ref(x, g, eps)
    return rmsnorm_triton(x, g, eps)


def layernorm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, *,
              eps: float = 1e-5) -> torch.Tensor:
    """x: (R, C); g, b: (C,)."""
    if runs_plain(x):
        return layernorm_ref(x, g, b, eps)
    return layernorm_triton(x, g, b, eps)

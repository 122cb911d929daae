"""Public activation ops: the Triton kernel for a CUDA tensor, the plain
version for a CPU tensor."""
from __future__ import annotations

import torch

from ...device import runs_plain
from .kernel import silu_mul_triton
from .ref import silu_mul_ref


def silu_mul(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """silu(g) * u, computed in fp32, one rounding."""
    if runs_plain(g):
        return silu_mul_ref(g, u)
    return silu_mul_triton(g, u)

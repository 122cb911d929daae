"""Public RG-LRU scan op: a CUDA kernel for a CUDA tensor (the chunked scan
for a call ``kernel.picks_chunked`` names, of more than one step,
else the step-by-step one), the plain version for a CPU tensor."""
from __future__ import annotations

from typing import Optional

import torch

from ...device import runs_plain
from . import kernel
from .ref import rglru_ref


def rglru(u: torch.Tensor, ga: torch.Tensor, gx: torch.Tensor, lam: torch.Tensor,
          gate: torch.Tensor, h0: Optional[torch.Tensor] = None,
          lengths: Optional[torch.Tensor] = None, *,
          h_out: Optional[torch.Tensor] = None):
    """u, gate: (B, T, d) bf16; ga, gx: (B, T, d) fp32; lam: (d,); h0: (B, d)
    fp32 or None (zeros); lengths: (B,) int32 or None. Returns (``gate * h``
    (B, T, d) fp32, h after each sequence's last real step (B, d)). With
    ``h_out`` the final h is written into it, in place, and returned; it may
    be ``h0`` itself."""
    if runs_plain(u):
        y, h = rglru_ref(u, ga, gx, lam, gate, h0, lengths)
        return y, h if h_out is None else h_out.copy_(h)
    args = (u.contiguous(), ga.contiguous(), gx.contiguous(), lam.contiguous(),
            gate.contiguous())
    launch = kernel.rglru_chunked_cuda if kernel.picks_chunked(*args[:3], args[4]) else \
        kernel.rglru_cuda
    return launch(*args, h0, lengths, h_out=h_out)

"""Public WKV op: a CUDA kernel for a CUDA tensor (the chunked one for a
call of more than one step that ``kernel.chunked_eligible`` accepts, else
the step-by-step one), the plain version for a CPU tensor."""
from __future__ import annotations

from typing import Optional

import torch

from ...device import runs_plain
from . import kernel
from .ref import wkv_ref


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
        u: torch.Tensor, state0: Optional[torch.Tensor] = None,
        lengths: Optional[torch.Tensor] = None, *,
        state_out: Optional[torch.Tensor] = None):
    """r, k, v, w: (B, T, H, N) fp32; u: (H, N); state0: (B, H, N, N) or None
    (zeros); lengths: (B,) int32 or None. Returns (out (B, T, H, N), final
    state (B, H, N, N)). With ``state_out`` the final state is written into
    it, in place, and returned; it may be ``state0`` itself.

    The card refuses, with ``ValueError``, what the kernels do not take and
    the plain version computes on the CPU: a head size N outside (32, 64),
    and inputs other than fp32."""
    if runs_plain(r):
        out, state = wkv_ref(r, k, v, w, u, state0, lengths)
        return out, state if state_out is None else state_out.copy_(state)
    launch = kernel.wkv_chunked_cuda if kernel.chunked_eligible(r, k, v, w) else \
        kernel.wkv_cuda
    return launch(r, k, v, w, u, state0, lengths, state_out=state_out)

"""Public WKV op: a CUDA kernel for a CUDA tensor (the chunked one for a
call of more than one step that ``kernel.chunked_eligible`` accepts, else
the step-by-step one), the plain version for a CPU tensor."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

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

    On the card a head size N below 128 other than 32 and 64 runs at the
    next of (32, 64, 128) (``kernel.kernel_head_size``), zero-padded: r, k,
    v and u padded with 0 and w with 1, the state with zero rows and
    columns, which stay 0, so the sliced output and state are exact. The
    card refuses, with ``ValueError``, what the kernels do not take and the
    plain version computes on the CPU: N above 128, and inputs other than
    fp32."""
    if runs_plain(r):
        out, state = wkv_ref(r, k, v, w, u, state0, lengths)
        return out, state if state_out is None else state_out.copy_(state)
    N = r.shape[-1]
    Nk = kernel.kernel_head_size(N)
    if Nk != N:
        pad = (0, Nk - N)
        s0 = None if state0 is None else F.pad(state0, pad + pad)
        out, state = wkv(*(F.pad(a, pad) for a in (r, k, v)), F.pad(w, pad, value=1.0),
                         F.pad(u, pad), s0, lengths)
        state = state[..., :N, :N]
        return out[..., :N], state if state_out is None else state_out.copy_(state)
    launch = kernel.wkv_chunked_cuda if kernel.chunked_eligible(r, k, v, w) else \
        kernel.wkv_cuda
    return launch(r, k, v, w, u, state0, lengths, state_out=state_out)

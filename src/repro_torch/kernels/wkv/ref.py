"""Plain PyTorch WKV recurrence, in the model's (B, T, H, N) layout of
``repro.models.recurrent.wkv_scan``."""
from __future__ import annotations

from typing import Optional

import torch


def wkv_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
            u: torch.Tensor, state0: Optional[torch.Tensor] = None,
            lengths: Optional[torch.Tensor] = None):
    """r, k, v, w: (B, T, H, N); u: (H, N) per-head bonus; state0:
    (B, H, N, N) or None (zeros); lengths: (B,) int32 or None (T steps
    everywhere). A sequential loop over T in fp32, the step of
    ``recurrent._wkv_step``:

        out_t = r_t @ (S + u^T (k_t^T v_t)),   S <- S * w_t^T + k_t^T v_t

    Steps at or past ``lengths[b]`` leave S as it is and output zeros. The
    contraction over the key channel is an elementwise product and a sum, so
    no matrix product (and no TF32) is involved. Returns out (B, T, H, N)
    and the final state (B, H, N, N), both fp32."""
    B, T, H, N = r.shape
    r, k, v, w, u = (a.float() for a in (r, k, v, w, u))
    if state0 is None:
        S = torch.zeros((B, H, N, N), dtype=torch.float32, device=r.device)
    else:
        S = state0.float().clone()
    out = torch.zeros((B, T, H, N), dtype=torch.float32, device=r.device)
    live = None
    if lengths is not None:
        live = torch.arange(T, device=r.device)[None, :] < lengths.to(r.device)[:, None]
    for t in range(T):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]            # (B, H, N, N)
        o = (r[:, t, :, :, None] * (S + u[:, :, None] * kv)).sum(-2)
        nxt = S * w[:, t, :, :, None] + kv
        if live is None:
            out[:, t], S = o, nxt
        else:
            m = live[:, t].view(B, 1, 1)
            out[:, t] = torch.where(m, o, 0.0)
            S = torch.where(m[..., None], nxt, S)
    return out, S

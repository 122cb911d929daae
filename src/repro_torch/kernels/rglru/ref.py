"""Plain PyTorch RG-LRU scan: the gates of
``repro/models/recurrent.py::_rglru_gates`` and the recurrence its
``rglru_apply`` runs with ``lax.associative_scan``, as a loop over steps."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

RGLRU_C = 8.0


def rglru_gates(u: torch.Tensor, ga: torch.Tensor, gx: torch.Tensor,
                lam: torch.Tensor):
    """a_t and b_t of ``h_t = a_t h_{t-1} + b_t`` in fp32: the recurrence
    gate ``r = sigmoid(ga)``, the input gate ``i = sigmoid(gx)``,
    ``log a = -8 r softplus(lam)`` and ``b = sqrt(max(1 - a^2, 1e-12)) i u``."""
    r = torch.sigmoid(ga)
    i = torch.sigmoid(gx)
    log_a = -RGLRU_C * r * F.softplus(lam)
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * (i * u.float())
    return a, b


def rglru_ref(u: torch.Tensor, ga: torch.Tensor, gx: torch.Tensor, lam: torch.Tensor,
              gate: torch.Tensor, h0: Optional[torch.Tensor] = None,
              lengths: Optional[torch.Tensor] = None):
    """u, gate: (B, T, d) bf16 (the conv output and the GELU branch); ga, gx:
    (B, T, d) fp32 (``u @ w_a``, ``u @ w_x``); lam: (d,) fp32; h0: (B, d)
    fp32 or None (zeros); lengths: (B,) int32 or None (T everywhere).
    Returns (``gate * h_t`` (B, T, d) fp32, h after each sequence's last real
    step (B, d) fp32). Steps at or past a sequence's length leave h as it
    is."""
    B, T, d = u.shape
    a, b = rglru_gates(u, ga, gx, lam)
    h = torch.zeros((B, d), dtype=torch.float32, device=u.device) if h0 is None \
        else h0.float().clone()
    live = torch.ones((B, T), dtype=torch.bool, device=u.device) if lengths is None \
        else torch.arange(T, device=u.device)[None, :] < lengths.to(u.device).long()[:, None]
    ys = []
    for t in range(T):
        h = torch.where(live[:, t, None], a[:, t] * h + b[:, t], h)
        ys.append(h)
    y = gate.float() * torch.stack(ys, dim=1) if T else torch.zeros_like(ga)
    return y, h

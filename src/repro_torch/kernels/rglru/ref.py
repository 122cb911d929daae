"""Plain PyTorch RG-LRU scan: the gates of
``repro/models/recurrent.py::_rglru_gates`` and the recurrence its
``rglru_apply`` runs with ``lax.associative_scan``, as a loop over steps
(``rglru_ref``, which the op runs on the CPU), and the chunked kernel's
arithmetic (``rglru_chunked_ref``, which the tests hold to it)."""
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
    log_a, b = _log_a_b(u, ga, gx, lam)
    return torch.exp(log_a), b


def _log_a_b(u, ga, gx, lam):
    log_a = -RGLRU_C * torch.sigmoid(ga) * F.softplus(lam)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * \
        (torch.sigmoid(gx) * u.float())
    return log_a, b


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


def rglru_chunked_ref(u: torch.Tensor, ga: torch.Tensor, gx: torch.Tensor,
                      lam: torch.Tensor, gate: torch.Tensor,
                      h0: Optional[torch.Tensor] = None,
                      lengths: Optional[torch.Tensor] = None, *, chunk: int):
    """The arithmetic of ``csrc/rglru_chunked.cu`` at ``chunk`` steps a
    segment, with ``rglru_ref``'s contract. Pad steps (at or past a
    sequence's length, and past T) are identity steps, log a = 0 and b = 0.
    Each chunk's summary is (P, hl): P = exp of the sum of its log a, hl its
    scan from zero. The summaries fold in order from h0, ``h = P h + hl``,
    giving each chunk's h_in, from which its steps run again."""
    B, T, d = u.shape
    log_a, b = _log_a_b(u, ga, gx, lam)
    if lengths is not None:
        live = (torch.arange(T, device=u.device)[None, :]
                < lengths.to(u.device).long()[:, None])[..., None]
        log_a, b = torch.where(live, log_a, 0.0), torch.where(live, b, 0.0)
    n = -(-T // chunk)
    pad = (0, 0, 0, n * chunk - T)
    la = F.pad(log_a, pad).view(B, n, chunk, d)
    a, bb = torch.exp(la), F.pad(b, pad).view(B, n, chunk, d)

    def scan(h):   # every chunk's steps from h (B, n, d)
        hs = []
        for j in range(chunk):
            h = a[:, :, j] * h + bb[:, :, j]
            hs.append(h)
        return torch.stack(hs, dim=2)

    p_end = torch.exp(la.sum(dim=2))
    hl_end = scan(torch.zeros((B, n, d), dtype=torch.float32, device=u.device))[:, :, -1]
    h = torch.zeros((B, d), dtype=torch.float32, device=u.device) if h0 is None \
        else h0.float().clone()
    h_in = []
    for c in range(n):
        h_in.append(h)
        h = p_end[:, c] * h + hl_end[:, c]
    if not n:
        return torch.zeros_like(ga), h
    hs = scan(torch.stack(h_in, dim=1))
    return gate.float() * hs.reshape(B, n * chunk, d)[:, :T], h

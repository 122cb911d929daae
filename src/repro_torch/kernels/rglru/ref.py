"""Plain PyTorch RG-LRU scan: the gates of
``repro/models/recurrent.py::_rglru_gates`` and the recurrence its
``rglru_apply`` runs with ``lax.associative_scan``, as a loop over steps
(``rglru_ref``, which the op runs on the CPU), the chunked kernel's
arithmetic (``rglru_chunked_ref``, which the tests hold to it), and the
gradient of ``rglru_ref`` as an explicit formula (``rglru_bwd_ref``, the
plain version of ``csrc/rglru_bwd.cu``)."""
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


def rglru_bwd_ref(u: torch.Tensor, ga: torch.Tensor, gx: torch.Tensor, lam: torch.Tensor,
                  gate: torch.Tensor, h0: Optional[torch.Tensor], dy: torch.Tensor,
                  dh_last: Optional[torch.Tensor] = None):
    """Gradients (du, dga, dgx, dlam, dgate, dh0) of ``rglru_ref`` (no
    lengths) for the output gradient `dy` (B, T, d) and the final state's
    `dh_last` (B, d) or None, as the explicit formula in fp32 that
    ``csrc/rglru_bwd.cu`` computes:

    - dh_t = dy_t gate_t + a_{t+1} dh_{t+1}, run from the end (dh_last
      added at the last step);
    - d(log a)_t = dh_t h_{t-1} a_t + dh_t i u d sqrt(.)/d log a, where
      d sqrt(max(1 - e, 1e-12))/d log a = -e / sqrt(.) with e = exp(2 log a),
      and 0 where the clamp holds (1 - e < 1e-12), as JAX's ``maximum``
      gives;
    - dga = d(log a) (-8 softplus(lam)) r (1 - r), dgx = dh sqrt(.) u i (1 - i),
      du = dh sqrt(.) i, dlam = the sum over batch and steps of
      d(log a) (-8 r) sigmoid(lam), dgate = dy h, dh0 = a_0 dh_0.

    du and dgate are rounded to u's and the gate's dtype, the rest fp32;
    dh0 is None when h0 is."""
    B, T, d = u.shape
    uf, r, i = u.float(), torch.sigmoid(ga), torch.sigmoid(gx)
    k = -RGLRU_C * F.softplus(lam)
    log_a = k * r
    a, e = torch.exp(log_a), torch.exp(2.0 * log_a)
    live = (1.0 - e) > 1e-12
    sq = torch.sqrt(torch.clamp(1.0 - e, min=1e-12))
    b = sq * (i * uf)
    h = torch.zeros((B, d), dtype=torch.float32, device=u.device) if h0 is None \
        else h0.float()
    hs = []
    for t in range(T):
        hs.append(h)
        h = a[:, t] * h + b[:, t]
    h_prev = torch.stack(hs, dim=1) if T else torch.zeros_like(ga)
    h_all = torch.cat([h_prev[:, 1:], h[:, None]], dim=1) if T else h_prev
    g = dy.float() * gate.float()
    carry = torch.zeros((B, d), dtype=torch.float32, device=u.device) if dh_last is None \
        else dh_last.float()
    dhs = [None] * T
    for t in reversed(range(T)):
        dh = g[:, t] + carry
        dhs[t] = dh
        carry = a[:, t] * dh
    dh = torch.stack(dhs, dim=1) if T else torch.zeros_like(ga)
    dsq = torch.where(live, -e / sq, 0.0)
    dlog_a = dh * h_prev * a + dh * i * uf * dsq
    dga = dlog_a * k * r * (1.0 - r)
    dgx = dh * sq * uf * i * (1.0 - i)
    du = dh * sq * i
    dlam = (dlog_a * (-RGLRU_C) * r).sum(dim=(0, 1)) * torch.sigmoid(lam)
    dgate = dy.float() * h_all
    dh0 = None if h0 is None else carry
    return du.to(u.dtype), dga, dgx, dlam, dgate.to(gate.dtype), dh0

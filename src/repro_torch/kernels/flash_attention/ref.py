"""Plain PyTorch attention in (B, H, S, D) layout, the layout of
``repro.kernels.flash_attention``."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  softcap: float = 0.0) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D) -> (B, Hq, Sq, D).
    GQA: query head h reads kv-head h // (Hq // Hkv)."""
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, Sq, D).float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) / math.sqrt(D)
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    qp = torch.arange(Sq, device=q.device)[:, None]
    kp = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qp >= kp
    if window > 0:
        mask &= kp > qp - window
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p.to(v.dtype).float(), v.float())
    return o.reshape(B, Hq, Sq, D).to(q.dtype)


def _logits(q, k, causal, window, softcap):
    """fp32 (B, Hkv, G, Sq, Sk) scaled (and capped) logits, the tanh of the
    cap (or None), and the (Sq, Sk) mask of live pairs."""
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    s = torch.einsum("bhgqd,bhkd->bhgqk", q.reshape(B, Hkv, Hq // Hkv, Sq, D).float(),
                     k.float()) * (1.0 / math.sqrt(D))
    t = None
    if softcap > 0:
        t = torch.tanh(s / softcap)
        s = softcap * t
    qp = torch.arange(Sq, device=q.device)[:, None]
    kp = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qp >= kp
    if window > 0:
        mask &= kp > qp - window
    return s, t, mask


def attention_lse_ref(q: torch.Tensor, k: torch.Tensor, *, causal: bool = True,
                      window: int = 0, softcap: float = 0.0) -> torch.Tensor:
    """fp32 (B, Hq, Sq): each row's log-sum-exp L = log(sum_j exp(s_j)), the
    natural log over the scaled (and capped) logits s of its live keys, as
    the wgmma forward kernel writes it; +inf for a row with no live key, so
    that exp(s - L) is 0 there."""
    B, Hq, Sq, _ = q.shape
    s, _, mask = _logits(q, k, causal, window, softcap)
    lse = torch.logsumexp(s.masked_fill(~mask, -math.inf), dim=-1)
    return lse.masked_fill(lse == -math.inf, math.inf).reshape(B, Hq, Sq)


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor | None = None, *,
                      causal: bool = True, window: int = 0, softcap: float = 0.0):
    """Gradients (dq, dk, dv) of ``attention_ref`` for the output gradient
    `do`, as the explicit formula the flash backward kernel computes, in
    fp32: P = softmax(s) of the (capped, masked) logits s (given the rows'
    log-sum-exp `lse`, as ``attention_lse_ref`` makes it, P = exp(s - lse)
    over the live keys and 0 elsewhere), dv = P^T do,
    dP = do v^T, delta = rowsum(do * o) of the forward output o as given,
    dS = P * (dP - delta) (times 1 - tanh^2 under a softcap), dq = dS k /
    sqrt(D), dk = dS^T q / sqrt(D); dk and dv summed over the G query heads
    of each kv-head. Each is rounded once to its input's dtype."""
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    qf = q.reshape(B, Hkv, G, Sq, D).float()
    kf, vf = k.float(), v.float()
    dof = do.reshape(B, Hkv, G, Sq, D).float()
    s, t, mask = _logits(q, k, causal, window, softcap)
    if lse is None:
        p = torch.softmax(s.masked_fill(~mask, NEG_INF), dim=-1)
    else:
        p = torch.exp(s - lse.reshape(B, Hkv, G, Sq, 1).float()).masked_fill(~mask, 0.0)
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p, dof)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", dof, vf)
    delta = (dof * o.reshape(B, Hkv, G, Sq, D).float()).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    if softcap > 0:
        ds = ds * (1 - t * t)
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, kf) * scale
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds, qf) * scale
    return dq.reshape(B, Hq, Sq, D).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)

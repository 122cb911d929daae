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


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, do: torch.Tensor, *, causal: bool = True,
                      window: int = 0, softcap: float = 0.0):
    """Gradients (dq, dk, dv) of ``attention_ref`` for the output gradient
    `do`, as the explicit formula the flash backward kernel computes, in
    fp32: P = softmax(s) of the (capped, masked) logits s, dv = P^T do,
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
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kf) * scale
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
    p = torch.softmax(s.masked_fill(~mask, NEG_INF), dim=-1)
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p, dof)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", dof, vf)
    delta = (dof * o.reshape(B, Hkv, G, Sq, D).float()).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    if softcap > 0:
        ds = ds * (1 - t * t)
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, kf) * scale
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds, qf) * scale
    return dq.reshape(B, Hq, Sq, D).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)

"""Plain PyTorch decode attention, in the layout of
``repro.kernels.decode_attention``."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         lengths: torch.Tensor,
                         softcap: float = 0.0) -> torch.Tensor:
    """q: (B, Hkv, G, D); k, v: (B, T, Hkv, D); lengths: (B,) valid keys."""
    D = q.shape[-1]
    s = torch.einsum("bhgd,bthd->bhgt", q.float(), k.float()) / math.sqrt(D)
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    t = torch.arange(k.shape[1], device=k.device)
    mask = t[None, :] < lengths.to(k.device)[:, None]
    s = s.masked_fill(~mask[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgt,bthd->bhgd", p.to(v.dtype).float(), v.float())
    return o.to(q.dtype)

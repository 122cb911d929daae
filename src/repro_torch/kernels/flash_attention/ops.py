"""Public fused-attention op: the CUDA kernel for a CUDA tensor, the plain
version for a CPU tensor."""
from __future__ import annotations

import torch

from ...device import runs_plain
from .kernel import flash_attention_cuda
from .ref import attention_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D) -> (B, Hq, Sq, D)."""
    if runs_plain(q):
        return attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap)
    return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                softcap=softcap)

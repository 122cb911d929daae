"""Public decode-attention op: the CUDA kernel for a CUDA tensor, the plain
version for a CPU tensor."""
from __future__ import annotations

import torch

from ...device import runs_plain
from .kernel import decode_attention_cuda
from .ref import decode_attention_ref


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, *,
                     softcap: float = 0.0) -> torch.Tensor:
    """q: (B, Hkv, G, D); k, v: (B, T, Hkv, D); lengths: (B,) int32.

    The card refuses, with ``ValueError``, what the kernel does not take and
    the plain version computes on the CPU: a head dim outside (32, 64, 128)
    (256 among them), and dtypes other than bf16 and fp32."""
    if runs_plain(q):
        return decode_attention_ref(q, k, v, lengths, softcap)
    return decode_attention_cuda(q, k, v, lengths, softcap=softcap)

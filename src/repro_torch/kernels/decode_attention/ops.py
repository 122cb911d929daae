"""Public decode-attention op: a CUDA kernel for a CUDA tensor (the chunked
one where ``kernel.chunked_eligible`` takes the call, else the split one),
the plain version for a CPU tensor."""
from __future__ import annotations

import torch

from ...device import runs_plain
from .kernel import decode_cuda
from .ref import decode_attention_ref


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, *,
                     softcap: float = 0.0) -> torch.Tensor:
    """q: (B, Hkv, G, D); k, v: (B, T, Hkv, D); lengths: (B,) int32.

    A head dim between 32, 64, 128 and 256 runs on the card zero-padded to
    the next of them, which is exact. The card refuses, with ``ValueError``,
    what no kernel takes and the plain version computes on the CPU: a head
    dim above 256, and dtypes other than bf16 and fp32."""
    if runs_plain(q):
        return decode_attention_ref(q, k, v, lengths, softcap)
    return decode_cuda(q, k, v, lengths, softcap=softcap)

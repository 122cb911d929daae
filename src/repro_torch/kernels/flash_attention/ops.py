"""Public fused-attention op: the CUDA kernels for a CUDA tensor, the plain
version for a CPU tensor."""
from __future__ import annotations

import torch

from ...device import runs_plain
from .kernel import attention_cuda
from .ref import attention_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D) -> (B, Hq, Sq, D).

    On the card bf16 at D = 64, 128 or 256 with TMA-describable strides
    runs on the TMA + wgmma kernel, every other bf16 or fp32 call on the
    mma.sync / fp32 kernel (``kernel.attention_cuda``); a head dim between
    32, 64, 128 and 256 runs zero-padded to the next of them, which is
    exact. The card refuses, with ``ValueError``, what neither kernel takes
    and the plain version computes on the CPU: a head dim above 256, and
    dtypes other than bf16 and fp32."""
    if runs_plain(q):
        return attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap)
    return attention_cuda(q, k, v, causal=causal, window=window, softcap=softcap)

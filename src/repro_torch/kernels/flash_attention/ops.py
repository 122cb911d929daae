"""Public fused-attention op: the CUDA kernels for a CUDA tensor, the plain
version for a CPU tensor.

The op is differentiable: where grad mode is on and q, k or v requires a
gradient, it runs as ``FlashAttentionFn``, whose forward is the same op
that also keeps each row's log-sum-exp L, and whose backward is
``attention_bwd_cuda`` on the card (the wgmma kernel, given L, or the
mma.sync one) and ``attention_bwd_ref`` given L on the CPU. Otherwise
(serving) it calls the forward directly, writes no L and builds no graph."""
from __future__ import annotations

import torch

from ...device import runs_plain
from .kernel import attention_bwd_cuda, attention_cuda
from .ref import attention_bwd_ref, attention_lse_ref, attention_ref


def _attention(q, k, v, causal, window, softcap):
    if runs_plain(q):
        return attention_ref(q, k, v, causal=causal, window=window, softcap=softcap)
    return attention_cuda(q, k, v, causal=causal, window=window, softcap=softcap)


class FlashAttentionFn(torch.autograd.Function):
    """Attention with its hand-written backward; saves q, k, v, the output
    and the rows' log-sum-exp L (None where the card's forward kernel
    writes none), and recomputes the probabilities from L in the backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        mask = {"causal": causal, "window": window, "softcap": softcap}
        if runs_plain(q):
            o, lse = attention_ref(q, k, v, **mask), attention_lse_ref(q, k, **mask)
        else:
            o, lse = attention_cuda(q, k, v, **mask, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask = mask
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if do.stride(-1) != 1:
            do = do.contiguous()
        bwd = attention_bwd_ref if runs_plain(q) else attention_bwd_cuda
        return (*bwd(q, k, v, o, do, lse, **ctx.mask), None, None, None)


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
    dtypes other than bf16 and fp32. Its backward on the card takes bf16
    causal, windowed or full attention with or without a softcap at D = 64,
    128 or 256 on the wgmma kernel (where the forward ran on one and the
    strides allow), at D = 64 or 128 on the mma.sync one, and refuses the
    rest (D = 256 at strides TMA cannot take: ROADMAP B28)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal, window, softcap)
    return _attention(q, k, v, causal, window, softcap)

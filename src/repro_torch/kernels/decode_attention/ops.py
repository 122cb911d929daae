"""Public decode-attention ops: a CUDA kernel for a CUDA tensor (the chunked
one where ``kernel.picks_chunked`` takes the call, else the split one), the
plain version for a CPU tensor; and ``attend_all_keys``, one query over
every key, which runs on the decode op or on flash attention."""
from __future__ import annotations

import torch

from ...device import runs_plain
from ..flash_attention.ops import flash_attention
from .kernel import decode_cuda, picks_chunked
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


def all_keys_on_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether ``attend_all_keys`` runs a call on the decode op: on the card,
    where the decode op would run it on the chunked kernel
    (``kernel.picks_chunked``); flash attention on the one query takes every
    other call, the split decode kernel none. Measured on an H100
    (``chip_smoke.py``'s timing phase, both forms on the same tensors): over
    whisper-tiny's 1500 cross keys at G = 1, D = 64 the chunked kernel beats
    flash; over llama-3.2-vision's 1601 at G = 4, D = 128 flash beats the
    split kernel, which splits the cache length and not the keys. Only
    these two shapes were measured."""
    return not runs_plain(q) and picks_chunked(q, k, v)


def attend_all_keys(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """One query a head over all of the keys, non-causal (a cross-attention
    at a decode step): q (B, Hkv, G, D); k, v (B, Sk, Hkv, D) -> (B, Hkv, G,
    D). The decode op with every length Sk or flash attention on the one
    query, which compute the same function (``all_keys_on_decode`` picks);
    the plain flash version on the CPU."""
    B, Hkv, G, D = q.shape
    if all_keys_on_decode(q, k, v):
        lengths = torch.full((B,), k.shape[1], dtype=torch.int32, device=q.device)
        return decode_cuda(q, k, v, lengths)
    o = flash_attention(q.reshape(B, Hkv * G, 1, D), k.transpose(1, 2), v.transpose(1, 2),
                        causal=False)
    return o.reshape(B, Hkv, G, D)

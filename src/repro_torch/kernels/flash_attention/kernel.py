"""Wrapper of the CUDA C++ flash-attention kernel
(``csrc/flash_attention.cu``), which replaces
``repro/kernels/flash_attention/kernel.py::flash_attention_pallas``.

The source file carries the kernel's design note and its bound on an H100.
The wrapper checks what the kernel takes, allocates the output, and launches
on the current stream. It takes (B, H, S, D) tensors with any batch, head and
sequence strides, so the model's (B, S, H, D) tensors pass as transposed
views without a copy; the output keeps q's memory layout. The kernel masks
the ragged end of the key axis itself, so nothing is padded (the TPU op's
``valid_k`` is the key length here).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from .. import _build

HEAD_DIMS = (32, 64, 128)


@functools.cache
def _entry():
    fn = _build.load("flash_attention").flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_longlong] * 12
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: int = 0,
                         softcap: float = 0.0) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D), CUDA, bf16 or fp32, unit
    stride along D; D in (32, 64, 128). Returns (B, Hq, Sq, D)."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash attention takes q (B,Hq,Sq,D) and k, v "
                         f"(B,Hkv,Sk,D), got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    if k.shape[0] != B or k.shape[3] != D or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"q {tuple(q.shape)} does not fit k {tuple(k.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash attention kernel takes D in {HEAD_DIMS}, got {D}")
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"flash attention kernel takes one dtype, bf16 or "
                         f"fp32, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError("flash attention kernel needs q, k, v on one CUDA device")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash attention kernel needs a unit stride along D")
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    err = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                   int(q.dtype == torch.bfloat16), B, Hq, Hkv, Sq, Sk, D,
                   *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                   *o.stride()[:3], int(causal), int(window), float(softcap),
                   1.0 / math.sqrt(D),
                   torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention_fwd")
    flash_attention_cuda.launches += 1
    return o


flash_attention_cuda.launches = 0

"""Wrapper of the CUDA C++ decode-attention kernel
(``csrc/decode_attention.cu``), which replaces
``repro/kernels/decode_attention/kernel.py::decode_attention_pallas``.

The source file carries the kernel's design note and its bound on an H100.
The wrapper checks what the kernel takes, picks the split of the cache
length over blocks, allocates the output and the fp32 scratch of the
splits' partial softmax states, and launches on the current stream. K and V
come in the fused cache's (B, T, Hkv, D) layout with any batch, time and
head strides.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from .. import _build

HEAD_DIMS = (32, 64, 128)
MIN_SPLIT_LEN = 64  # keys per split at the least
BLOCKS_PER_SM = 4   # split the cache length until this many blocks run


@functools.cache
def _entry():
    fn = _build.load("decode_attention").decode_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                   + [ctypes.c_longlong] * 6
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def n_splits(device: torch.device, B: int, Hkv: int, G: int, T: int) -> int:
    """Splits of the cache length: enough blocks for BLOCKS_PER_SM per SM,
    but no split shorter than MIN_SPLIT_LEN keys."""
    group_chunk = 2 if G <= 2 else 8        # heads per block, as in the source
    blocks = B * Hkv * -(-G // group_chunk)
    index = device.index if device.index is not None else torch.cuda.current_device()
    want = -(-BLOCKS_PER_SM * _sm_count(index) // blocks)
    return max(1, min(want, -(-T // MIN_SPLIT_LEN)))


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          lengths: torch.Tensor, *,
                          softcap: float = 0.0) -> torch.Tensor:
    """q: (B, Hkv, G, D) contiguous; k, v: (B, T, Hkv, D) with unit stride
    along D; lengths: (B,) int32; all on one CUDA device, q/k/v bf16 or
    fp32, D in (32, 64, 128). Returns (B, Hkv, G, D)."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"decode attention takes q (B,Hkv,G,D) and k, v "
                         f"(B,T,Hkv,D), got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Hkv, G, D = q.shape
    T = k.shape[1]
    if k.shape[0] != B or k.shape[2] != Hkv or k.shape[3] != D:
        raise ValueError(f"q {tuple(q.shape)} does not fit k {tuple(k.shape)}")
    if lengths.shape != (B,) or lengths.dtype != torch.int32:
        raise ValueError(f"lengths must be (B,) int32, got "
                         f"{tuple(lengths.shape)} {lengths.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"decode attention kernel takes D in {HEAD_DIMS}, got {D}")
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"decode attention kernel takes one dtype, bf16 or "
                         f"fp32, got {q.dtype}, {k.dtype}, {v.dtype}")
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev for t in (k, v, lengths)):
        raise ValueError("decode attention kernel needs q, k, v, lengths on "
                         "one CUDA device")
    if not q.is_contiguous() or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("decode attention kernel needs a contiguous q and a "
                         "unit stride along D for k and v")
    lengths = lengths.contiguous()
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    if out.numel() == 0:
        return out
    n_split = n_splits(dev, B, Hkv, G, T)
    split_len = -(-T // n_split)
    part = torch.empty(B * Hkv * G * n_split * (D + 2), dtype=torch.float32,
                       device=dev)
    err = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
                   part.data_ptr(), out.data_ptr(),
                   int(q.dtype == torch.bfloat16), B, Hkv, G, D, n_split,
                   split_len, k.stride(0), k.stride(1), k.stride(2),
                   v.stride(0), v.stride(1), v.stride(2), float(softcap),
                   1.0 / math.sqrt(D), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "decode_attention_fwd")
    decode_attention_cuda.launches += 1
    return out


decode_attention_cuda.launches = 0

"""Wrappers of the CUDA C++ decode-attention kernels, which replace
``repro/kernels/decode_attention/kernel.py::decode_attention_pallas``:

- ``decode_attention_chunked_cuda`` (``csrc/decode_attention_chunked.cu``):
  bf16 at D in ``CHUNKED_HEAD_DIMS`` with bases and strides that 16-byte
  loads can take (``chunked_eligible``): the live keys, counted from the
  lengths on the device, cut into units and shared equally among the card's
  warps, the partials' merge in the same launch. The model's decode step
  takes this path at G <= ``CHUNKED_MAX_G``;
- ``decode_attention_cuda`` (``csrc/decode_attention.cu``): everything else
  the card computes: more query heads a kv-head, fp32, and bf16 whose bases
  or strides are off 16 bytes (a split of the cache length T over blocks,
  then a merge kernel), at D = 32, 64, 128 or 256.

``decode_cuda`` picks between the two before the launch (``picks_chunked``):
the chunked kernel where ``chunked_eligible`` holds and a kv-head has at most
``CHUNKED_MAX_G`` query heads, the split kernel otherwise. The crossover was
measured on an H100 (``chip_smoke.py``, the G sweep of its timing phase): the
chunked kernel is the faster at G <= 2, the split one from G = 3 on. A head
dim between the kernels' (up to 256) runs at the next one up
(``kernel_head_dim``): q, k and v zero-padded along D, the true D's
``1/sqrt(D)`` passed as the scale, the output sliced back, which is exact. The
source files carry the kernels' design notes and their bounds on an H100. Each
wrapper checks what its kernel takes, allocates the output and the fp32
scratch of the partial softmax states (sized from T, never from the lengths,
which stay on the device), launches on the current stream and counts its own
launches. K and V come in the fused cache's (B, T, Hkv, D) layout with any
batch, time and head strides.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from .. import _build

HEAD_DIMS = (32, 64, 128, 256)
#: head dims of the chunked kernel
CHUNKED_HEAD_DIMS = (32, 64, 128, 256)
#: the most query heads per kv-head the chunked kernel takes (the crossover)
CHUNKED_MAX_G = 2
MIN_SPLIT_LEN = 64  # keys per split at the least (the split kernel)
BLOCKS_PER_SM = 4   # split the cache length until this many blocks run

_KV_ARGS = [ctypes.c_longlong] * 6 + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
_ENTRIES = {
    "decode_attention_fwd": ("decode_attention",
                             [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + _KV_ARGS),
    "decode_attention_chunked_fwd": ("decode_attention_chunked",
                                     [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + _KV_ARGS),
}


@functools.cache
def _entry(fn_name: str):
    lib_name, argtypes = _ENTRIES[fn_name]
    fn = getattr(_build.load(lib_name), fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def _tickets(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """The chunked kernel's n merge counters for launches on `stream`: zero
    before each launch, and reset to zero by the launch itself."""
    return torch.zeros(n, dtype=torch.int32, device=device)


def kernel_head_dim(D: int) -> int:
    """The head dim of ``HEAD_DIMS`` a call at D runs at: the least one at
    or above D. Above 256 raises."""
    for k in HEAD_DIMS:
        if D <= k:
            return k
    raise ValueError(f"decode attention kernels take D up to {HEAD_DIMS[-1]}, got {D}")


def chunk_keys(D: int) -> int:
    """Keys of one unit of the chunked kernel at head dim D (a warp's 8
    rows of 16-byte loads per lane: 4 KB of K and 4 KB of V): 64, 32, 16
    and 8 at D = 32, 64, 128 and 256."""
    return 2048 // D


def max_chunks(T: int, D: int) -> int:
    """Units of a slot at the full cache length T (at least 1), which bound
    the partial states of a slot-head: the scratch holds this many per query
    head. The kernel walks max(1, ceil(min(max(length, 0), T) / UK)) units
    of a slot, on the device."""
    return max(1, -(-T // chunk_keys(D)))


def scratch_floats(B: int, Hkv: int, G: int, T: int, D: int) -> int:
    """fp32 values of the chunked kernel's scratch: m, l and acc[D] per
    (b, kv-head, query head, partial), for ``max_chunks(T, D)`` partials."""
    return B * Hkv * G * max_chunks(T, D) * (D + 2)


def _check(what, q, k, v, lengths, dtypes, head_dims) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{what} takes q (B,Hkv,G,D) and k, v (B,T,Hkv,D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Hkv, G, D = q.shape
    if k.shape[0] != B or k.shape[2] != Hkv or k.shape[3] != D:
        raise ValueError(f"q {tuple(q.shape)} does not fit k {tuple(k.shape)}")
    if lengths.shape != (B,) or lengths.dtype != torch.int32:
        raise ValueError(f"lengths must be (B,) int32, got {tuple(lengths.shape)} "
                         f"{lengths.dtype}")
    if D not in head_dims:
        raise ValueError(f"{what} kernel takes D in {head_dims}, got {D}")
    if q.dtype not in dtypes or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{what} kernel takes one dtype of {dtypes}, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev for t in (k, v, lengths)):
        raise ValueError(f"{what} kernel needs q, k, v, lengths on one CUDA device")
    if not q.is_contiguous() or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError(f"{what} kernel needs a contiguous q and a unit stride along D "
                         "for k and v")


def chunked_eligible(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether the chunked kernel takes a decode call: q, k, v bf16, q
    (B, Hkv, G, D) contiguous with D in ``CHUNKED_HEAD_DIMS``, k and v
    (B, T, Hkv, D) with a unit stride along D, 16-byte aligned bases and
    batch, time and head strides (of an axis longer than 1) that are
    multiples of 8 elements, and q's base 16-byte aligned too, as its
    16-byte loads need. The model's cache views qualify."""
    if any(t.dtype != torch.bfloat16 or t.dim() != 4 for t in (q, k, v)):
        return False
    if q.shape[3] not in CHUNKED_HEAD_DIMS or not q.is_contiguous() or q.data_ptr() % 16:
        return False
    return all(t.stride(3) == 1 and t.data_ptr() % 16 == 0
               and all(s % 8 == 0 for n, s in zip(t.shape[:3], t.stride()[:3]) if n > 1)
               for t in (k, v))


def picks_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether ``decode_cuda`` runs a call on the chunked kernel: it takes
    the call (``chunked_eligible``) and G <= ``CHUNKED_MAX_G``, where it
    is the faster of the two."""
    return chunked_eligible(q, k, v) and q.shape[2] <= CHUNKED_MAX_G


def decode_attention_chunked_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                  lengths: torch.Tensor, *, softcap: float = 0.0,
                                  scale: float | None = None) -> torch.Tensor:
    """q: (B, Hkv, G, D); k, v: (B, T, Hkv, D); lengths: (B,) int32; bf16 on
    one CUDA device, which ``chunked_eligible`` must accept (a call it
    refuses raises: ``decode_cuda`` sends it to ``decode_attention_cuda``).
    The logits are q.k times `scale` (1/sqrt(D) by default). One launch;
    nothing is read back to the host. Returns (B, Hkv, G, D)."""
    _check("decode_attention_chunked", q, k, v, lengths, (torch.bfloat16,),
           CHUNKED_HEAD_DIMS)
    if not chunked_eligible(q, k, v):
        raise ValueError("decode_attention_chunked kernel takes q, k and v with 16-byte "
                         "aligned bases and strides that are multiples of 8 elements")
    B, Hkv, G, D = q.shape
    T = k.shape[1]
    dev = q.device
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lengths = lengths.contiguous()
    part = torch.empty(scratch_floats(B, Hkv, G, T, D), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _entry("decode_attention_chunked_fwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(), part.data_ptr(),
        _tickets(dev, stream, B * Hkv * G).data_ptr(), out.data_ptr(), B, T, Hkv, G, D,
        max_chunks(T, D), k.stride(0), k.stride(1), k.stride(2), v.stride(0), v.stride(1),
        v.stride(2), float(softcap), 1.0 / math.sqrt(D) if scale is None else scale, stream)
    _build.check(err, "decode_attention_chunked_fwd")
    decode_attention_chunked_cuda.launches += 1
    return out


decode_attention_chunked_cuda.launches = 0


def n_splits(device: torch.device, B: int, Hkv: int, G: int, T: int, D: int = 128) -> int:
    """Splits of the cache length for the split kernel: enough blocks for
    BLOCKS_PER_SM per SM, but no split shorter than MIN_SPLIT_LEN keys."""
    group_chunk = 2 if G <= 2 or D == 256 else 8   # heads per block, as in the source
    blocks = B * Hkv * -(-G // group_chunk)
    index = device.index if device.index is not None else torch.cuda.current_device()
    want = -(-BLOCKS_PER_SM * _sm_count(index) // blocks)
    return max(1, min(want, -(-T // MIN_SPLIT_LEN)))


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          lengths: torch.Tensor, *, softcap: float = 0.0,
                          scale: float | None = None) -> torch.Tensor:
    """q: (B, Hkv, G, D) contiguous; k, v: (B, T, Hkv, D) with unit stride
    along D; lengths: (B,) int32; all on one CUDA device, q/k/v bf16 or
    fp32, D in ``HEAD_DIMS``; the logits are q.k times `scale` (1/sqrt(D) by
    default). Returns (B, Hkv, G, D)."""
    _check("decode attention", q, k, v, lengths, (torch.bfloat16, torch.float32), HEAD_DIMS)
    B, Hkv, G, D = q.shape
    T = k.shape[1]
    dev = q.device
    lengths = lengths.contiguous()
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    if out.numel() == 0:
        return out
    n_split = n_splits(dev, B, Hkv, G, T, D)
    split_len = -(-T // n_split)
    part = torch.empty(B * Hkv * G * n_split * (D + 2), dtype=torch.float32,
                       device=dev)
    err = _entry("decode_attention_fwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(), part.data_ptr(),
        out.data_ptr(), int(q.dtype == torch.bfloat16), B, Hkv, G, D, n_split, split_len,
        k.stride(0), k.stride(1), k.stride(2), v.stride(0), v.stride(1), v.stride(2),
        float(softcap), 1.0 / math.sqrt(D) if scale is None else scale,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "decode_attention_fwd")
    decode_attention_cuda.launches += 1
    return out


decode_attention_cuda.launches = 0


def decode_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lengths: torch.Tensor, *,
                softcap: float = 0.0) -> torch.Tensor:
    """The op's decode attention on the card: calls ``picks_chunked``
    accepts go to ``decode_attention_chunked_cuda``, all others to
    ``decode_attention_cuda``; a head dim between the kernels' runs
    zero-padded to ``kernel_head_dim`` at its own scale, the output sliced
    back."""
    D = q.shape[-1]
    Dk = kernel_head_dim(D)
    if Dk != D:
        q, k, v = (torch.nn.functional.pad(t, (0, Dk - D)) for t in (q, k, v))
    kernel = decode_attention_chunked_cuda if picks_chunked(q, k, v) \
        else decode_attention_cuda
    o = kernel(q, k, v, lengths, softcap=softcap, scale=1.0 / math.sqrt(D))
    return o if Dk == D else o[..., :D].contiguous()

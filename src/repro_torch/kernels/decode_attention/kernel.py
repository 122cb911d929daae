"""Wrappers of the CUDA C++ decode-attention kernels, which replace
``repro/kernels/decode_attention/kernel.py::decode_attention_pallas``:

- ``decode_attention_chunked_cuda`` (``csrc/decode_attention_chunked.cu``):
  bf16 at D in ``CHUNKED_HEAD_DIMS`` with bases and strides that 16-byte
  loads can take (``chunked_eligible``): the live keys, counted from the
  lengths on the device, cut into units and shared equally among the card's
  warps, the partials' merge in the same launch, scores on scalar FMAs. The
  model's decode step takes this path at G <= ``CHUNKED_MAX_G``;
- ``decode_attention_mma_cuda`` (``csrc/decode_attention_mma.cu``): the same
  calls at G > ``CHUNKED_MAX_G``: the group's query heads,
  padded to ``MMA_ROWS``, on the tensor cores (mma.sync) over units of
  ``MMA_UNIT_KEYS`` live keys staged in shared memory by cp.async, each
  (slot, item) run cut into equal segments of the card's blocks, the
  segments' merge in the same launch;
- ``decode_attention_cuda`` (``csrc/decode_attention.cu``): everything else
  the card computes: fp32, and bf16 whose bases or strides are off 16 bytes
  (a split of the cache length T over blocks, then a merge kernel), at D =
  32, 64, 128 or 256.

``decode_cuda`` picks among the three before the launch (``decode_kernel``).
The crossover was measured on an H100 (``chip_smoke.py``, the G sweep of its
timing phase, every kernel on the same tensors, and the chunked and the mma
kernel in alternating turns at the served G = 1 and G = 2 shapes): the
chunked kernel is the faster at G = 1 (stablelm-1.6b, gpt3-175b,
whisper-tiny), the mma kernel from G = 2 on (qwen3-1.7b's G = 2 among them;
the times are in PERF.md's kernel table, row 8). A head dim between the
kernels' (up to 256) runs at the next one up (``kernel_head_dim``): q, k and
v zero-padded along D, the true D's ``1/sqrt(D)`` passed as the scale, the
output sliced back, which is exact. The source files carry the kernels'
design notes and their bounds on an H100. Each wrapper checks what its kernel
takes, allocates the output and the fp32 scratch of the partial softmax
states (sized from T, never from the lengths, which stay on the device),
launches on the current stream and counts its own launches. K and V come in
the fused cache's (B, T, Hkv, D) layout with any batch, time and head
strides.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from .. import _build
from ...device import address, on_card, sm_count, traced
from .._trace import launched

HEAD_DIMS = (32, 64, 128, 256)
#: head dims of the chunked kernel
CHUNKED_HEAD_DIMS = (32, 64, 128, 256)
#: the most query heads per kv-head the op sends to the chunked kernel (the
#: crossover with the mma kernel)
CHUNKED_MAX_G = 1
#: keys of a unit of the mma kernel: two n8 blocks of S, one k16 step of P V
MMA_UNIT_KEYS = 16
#: query heads of an item of the mma kernel (the m16 of mma.sync); a larger
#: group is cut into items of this many, each reading K and V again
MMA_ROWS = 16
#: segments of a (slot, item) run of the mma kernel, at most (the source's MAX_SEGS)
MMA_MAX_SEGS = 32
#: fp32 values of a run's segment states (rows x D each) the mma kernel's
#: bound on a run's segments allows: the block that merges them reads them
#: all (80 KB: recurrentgemma-2b's G = 10 at D = 256 gets 8 segments)
MMA_SEG_BUDGET = 20480
MIN_SPLIT_LEN = 64  # keys per split at the least (the split kernel)
BLOCKS_PER_SM = 4   # split the cache length until this many blocks run

_KV_ARGS = [ctypes.c_longlong] * 6 + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
_ENTRIES = {
    "decode_attention_fwd": ("decode_attention",
                             [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + _KV_ARGS),
    "decode_attention_chunked_fwd": ("decode_attention_chunked",
                                     [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + _KV_ARGS),
    "decode_attention_mma_fwd": ("decode_attention_mma",
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
def _tickets(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """n merge counters of the chunked or the mma kernel for launches on
    `stream`: zero before each launch, and reset to zero by the launch
    itself (so the two kernels may share them)."""
    return torch.zeros(n, dtype=torch.int32, device=device)


def decode_ops(q: torch.Tensor, k: torch.Tensor) -> int:
    """Operations of a decode launch: q.k and p.v, 2 D each a (query head,
    key) pair, over every key slot of the cache (the live lengths are data,
    which a trace cannot read)."""
    B, Hkv, G, D = q.shape
    return 4 * D * G * Hkv * B * k.shape[1]


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
    if not on_card(q) or any(t.device != dev for t in (k, v, lengths)):
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
    if q.shape[3] not in CHUNKED_HEAD_DIMS or not q.is_contiguous() or address(q) % 16:
        return False
    return all(t.stride(3) == 1 and address(t) % 16 == 0
               and all(s % 8 == 0 for n, s in zip(t.shape[:3], t.stride()[:3]) if n > 1)
               for t in (k, v))


def picks_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether ``decode_cuda`` runs a call on the chunked kernel: it takes
    the call (``chunked_eligible``) and G <= ``CHUNKED_MAX_G`` (one query
    head a kv-head), where it is the faster one."""
    return chunked_eligible(q, k, v) and q.shape[2] <= CHUNKED_MAX_G


def decode_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The name (in ``repro_torch.kernels.KERNELS``) of the kernel
    ``decode_cuda`` runs a call on: the chunked one where ``picks_chunked``
    holds, the mma one for the other calls ``chunked_eligible`` takes (its
    16-byte copies need what the chunked kernel's loads need), else the
    split one (fp32, strides off 16 bytes)."""
    if picks_chunked(q, k, v):
        return "decode_attention_chunked"
    return "decode_attention_mma" if chunked_eligible(q, k, v) else "decode_attention"


def mma_units(T: int) -> int:
    """Units of ``MMA_UNIT_KEYS`` keys of a slot at the full cache length T
    (at least 1): no run has more segments. The kernel walks max(1,
    ceil(min(max(length, 0), T) / MMA_UNIT_KEYS)) units of a slot, on the
    device."""
    return max(1, -(-T // MMA_UNIT_KEYS))


def mma_items(G: int) -> int:
    """Items of ``MMA_ROWS`` query heads a kv-head's G heads are cut into."""
    return -(-G // MMA_ROWS)


def mma_segments(T: int, G: int, D: int) -> int:
    """The most segments the mma kernel cuts a (slot, item) run into, and so
    the segment states a (slot, query head) row of its scratch holds: as
    many as keep a run's states (min(G, MMA_ROWS) rows of D floats each)
    within ``MMA_SEG_BUDGET`` floats, between 1 and ``MMA_MAX_SEGS``, and
    at most a slot's units at the full cache length T."""
    bound = max(1, min(MMA_MAX_SEGS, MMA_SEG_BUDGET // (min(G, MMA_ROWS) * D)))
    return min(bound, mma_units(T))


def mma_scratch_floats(B: int, Hkv: int, G: int, T: int, D: int) -> int:
    """fp32 values of the mma kernel's scratch: m, l and acc[D] per (b,
    kv-head, query head, segment), for ``mma_segments`` segments."""
    return B * Hkv * G * mma_segments(T, G, D) * (D + 2)


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
    if traced(q):
        return launched(decode_attention_chunked_cuda, decode_ops(q, k), out)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _entry("decode_attention_chunked_fwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(), part.data_ptr(),
        _tickets(dev, stream, B * Hkv * G).data_ptr(), out.data_ptr(), B, T, Hkv, G, D,
        max_chunks(T, D), k.stride(0), k.stride(1), k.stride(2), v.stride(0), v.stride(1),
        v.stride(2), float(softcap), 1.0 / math.sqrt(D) if scale is None else scale, stream)
    _build.check(err, "decode_attention_chunked_fwd")
    launched(decode_attention_chunked_cuda, decode_ops(q, k))
    return out


decode_attention_chunked_cuda.launches = 0


def decode_attention_mma_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              lengths: torch.Tensor, *, softcap: float = 0.0,
                              scale: float | None = None) -> torch.Tensor:
    """q: (B, Hkv, G, D); k, v: (B, T, Hkv, D); lengths: (B,) int32; bf16 on
    one CUDA device, which ``chunked_eligible`` must accept (a call it
    refuses raises: ``decode_cuda`` sends it to ``decode_attention_cuda``).
    The logits are q.k times `scale` (1/sqrt(D) by default); no run is cut
    into more than ``mma_segments`` segments. One launch; nothing is read
    back to the host. Returns (B, Hkv, G, D)."""
    _check("decode_attention_mma", q, k, v, lengths, (torch.bfloat16,), HEAD_DIMS)
    if not chunked_eligible(q, k, v):
        raise ValueError("decode_attention_mma kernel takes q, k and v with 16-byte "
                         "aligned bases and strides that are multiples of 8 elements")
    B, Hkv, G, D = q.shape
    T = k.shape[1]
    dev = q.device
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lengths = lengths.contiguous()
    part = torch.empty(mma_scratch_floats(B, Hkv, G, T, D), dtype=torch.float32, device=dev)
    if traced(q):
        return launched(decode_attention_mma_cuda, decode_ops(q, k), out)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _entry("decode_attention_mma_fwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(), part.data_ptr(),
        _tickets(dev, stream, B * Hkv * mma_items(G)).data_ptr(), out.data_ptr(), B, T, Hkv,
        G, D, mma_segments(T, G, D), k.stride(0), k.stride(1), k.stride(2), v.stride(0),
        v.stride(1), v.stride(2), float(softcap),
        1.0 / math.sqrt(D) if scale is None else scale, stream)
    _build.check(err, "decode_attention_mma_fwd")
    launched(decode_attention_mma_cuda, decode_ops(q, k))
    return out


decode_attention_mma_cuda.launches = 0


def n_splits(sms: int, B: int, Hkv: int, G: int, T: int, D: int = 128) -> int:
    """Splits of the cache length for the split kernel on a card of `sms`
    SMs: enough blocks for BLOCKS_PER_SM per SM, but no split shorter than
    MIN_SPLIT_LEN keys."""
    group_chunk = 2 if G <= 2 or D == 256 else 8   # heads per block, as in the source
    blocks = B * Hkv * -(-G // group_chunk)
    want = -(-BLOCKS_PER_SM * sms // blocks)
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
    n_split = n_splits(sm_count(q), B, Hkv, G, T, D)
    split_len = -(-T // n_split)
    part = torch.empty(B * Hkv * G * n_split * (D + 2), dtype=torch.float32,
                       device=dev)
    if traced(q):
        return launched(decode_attention_cuda, decode_ops(q, k), out)
    err = _entry("decode_attention_fwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(), part.data_ptr(),
        out.data_ptr(), int(q.dtype == torch.bfloat16), B, Hkv, G, D, n_split, split_len,
        k.stride(0), k.stride(1), k.stride(2), v.stride(0), v.stride(1), v.stride(2),
        float(softcap), 1.0 / math.sqrt(D) if scale is None else scale,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "decode_attention_fwd")
    launched(decode_attention_cuda, decode_ops(q, k))
    return out


decode_attention_cuda.launches = 0


def decode_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lengths: torch.Tensor, *,
                softcap: float = 0.0) -> torch.Tensor:
    """The op's decode attention on the card, on the kernel
    ``decode_kernel`` names: ``decode_attention_chunked_cuda`` (G <=
    ``CHUNKED_MAX_G``), ``decode_attention_mma_cuda`` (G above it) or
    ``decode_attention_cuda`` (fp32, strides off 16 bytes); a head dim
    between the kernels' runs zero-padded to ``kernel_head_dim`` at its own
    scale, the output sliced back."""
    D = q.shape[-1]
    Dk = kernel_head_dim(D)
    if Dk != D:
        q, k, v = (torch.nn.functional.pad(t, (0, Dk - D)) for t in (q, k, v))
    kernel = {"decode_attention_chunked": decode_attention_chunked_cuda,
              "decode_attention_mma": decode_attention_mma_cuda,
              "decode_attention": decode_attention_cuda}[decode_kernel(q, k, v)]
    o = kernel(q, k, v, lengths, softcap=softcap, scale=1.0 / math.sqrt(D))
    return o if Dk == D else o[..., :D].contiguous()

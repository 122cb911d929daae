"""Wrappers of the CUDA C++ flash-attention kernels, which replace
``repro/kernels/flash_attention/kernel.py::flash_attention_pallas``:

- ``flash_attention_wgmma_cuda`` (``csrc/flash_attention_sm90.cu``): bf16 at
  D = 64, 128 or 256 with strides a TMA descriptor can describe
  (``wgmma_eligible``): K and V tiles fed by TMA into a ring of shared-memory
  stages, both products on wgmma. The model's prefill takes this path;
- ``flash_attention_cuda`` (``csrc/flash_attention.cu``): everything else the
  card computes: bf16 on mma.sync (D = 32, or strides or bases TMA cannot
  take) and fp32 on scalar FMAs (its 2e-5 tolerance rules out bf16 MMAs),
  at D = 32, 64, 128 or 256.

``attention_cuda`` picks between the two by ``wgmma_eligible``, before the
launch. A head dim between the kernels' (up to 256) runs at the next one up
(``kernel_head_dim``): q, k and v zero-padded along D, the true D's
``1/sqrt(D)`` passed as the scale, the output sliced back; zeros add nothing
to q.k and give zero output columns, so this is exact. The source files carry
the kernels' design notes and their bounds on an H100. Each wrapper checks
what its kernel takes, allocates the output and launches on the current
stream, and counts its own launches. Both take (B, H, S, D) tensors with any
batch, head and sequence strides, so the model's (B, S, H, D) tensors pass as
transposed views without a copy; the output keeps q's memory layout (a padded
call's is a slice of its padded output). The kernels mask the ragged end of
the key axis themselves, so nothing is padded (the TPU op's ``valid_k`` is the
key length here). A head dim above 256 raises on the card; the op's plain
version computes it on the CPU.

``flash_attention_bwd_cuda`` (``csrc/flash_attention_bwd.cu``, whose note
gives its design) is the backward of a train step: dq, dk, dv of causal or
full bf16 attention at D = 64 or 128, GQA summed in the kernel, on the
same strided views.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from .. import _build

HEAD_DIMS = (32, 64, 128, 256)
#: head dims of the TMA + wgmma kernel
WGMMA_HEAD_DIMS = (64, 128, 256)

_STRIDE_ARGS = [ctypes.c_longlong] * 12
_TAIL_ARGS = [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
_ENTRIES = {
    "flash_attention_fwd": ("flash_attention",
                            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + _STRIDE_ARGS
                            + _TAIL_ARGS),
    "flash_attention_sm90_fwd": ("flash_attention_sm90",
                                 [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + _STRIDE_ARGS
                                 + _TAIL_ARGS),
}


@functools.cache
def _entry(fn_name: str):
    lib_name, argtypes = _ENTRIES[fn_name]
    fn = getattr(_build.load(lib_name), fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _work_counter(device: torch.device, stream: int) -> torch.Tensor:
    """The wgmma kernel's two work counters for launches on `stream`: zero
    before each launch, and reset to zero by the launch itself."""
    return torch.zeros(2, dtype=torch.int32, device=device)


def _check(what: str, q, k, v, dtypes, head_dims) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{what} takes q (B,Hq,Sq,D) and k, v (B,Hkv,Sk,D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    if k.shape[0] != B or k.shape[3] != D or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"q {tuple(q.shape)} does not fit k {tuple(k.shape)}")
    if D not in head_dims:
        raise ValueError(f"{what} kernel takes D in {head_dims}, got {D}")
    if q.dtype not in dtypes or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{what} kernel takes one dtype of {dtypes}, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"{what} kernel needs q, k, v on one CUDA device")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError(f"{what} kernel needs a unit stride along D")


def _tma_strides(t: torch.Tensor) -> tuple:
    """t's (batch, head, seq) element strides, with the stride of an axis of
    extent 1 (never stepped along) replaced by a valid one."""
    return tuple(s if n > 1 else 8 * max(1, t.numel())
                 for n, s in zip(t.shape[:3], t.stride()[:3]))


def kernel_head_dim(D: int) -> int:
    """The head dim of ``HEAD_DIMS`` a call at D runs at: the least one at
    or above D. Above 256 raises."""
    for k in HEAD_DIMS:
        if D <= k:
            return k
    raise ValueError(f"flash attention kernels take D up to {HEAD_DIMS[-1]}, got {D}")


def wgmma_eligible(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether the TMA + wgmma kernel takes an attention call: q, k, v bf16
    (B, H, S, D) with D in ``WGMMA_HEAD_DIMS``, nonempty, a unit stride
    along D, every base 16-byte aligned and every batch, head and sequence
    stride (of an axis longer than 1) a positive multiple of 8 elements, as
    a TMA descriptor needs. The model's transposed (B, S, H, D) views at the
    served widths qualify."""
    ts = (q, k, v)
    if any(t.dtype != torch.bfloat16 or t.dim() != 4 for t in ts):
        return False
    if q.shape[3] not in WGMMA_HEAD_DIMS or q.numel() == 0 or k.numel() == 0:
        return False
    return all(t.stride(3) == 1 and t.data_ptr() % 16 == 0
               and all(s > 0 and s % 8 == 0 for s in _tma_strides(t)) for t in ts)


def flash_attention_wgmma_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                               causal: bool = True, window: int = 0,
                               softcap: float = 0.0, scale: float | None = None
                               ) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D), bf16 on one CUDA device,
    which ``wgmma_eligible`` must accept (a call it refuses raises:
    ``attention_cuda`` sends it to ``flash_attention_cuda``). The logits are
    q.k times `scale` (1/sqrt(D) by default). Returns (B, Hq, Sq, D)."""
    _check("flash_attention_wgmma", q, k, v, (torch.bfloat16,), WGMMA_HEAD_DIMS)
    if not wgmma_eligible(q, k, v):
        raise ValueError("flash_attention_wgmma kernel takes nonempty tensors with 16-byte "
                         "aligned bases and strides that are multiples of 8 elements")
    o = torch.empty_like(q)
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _entry("flash_attention_sm90_fwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        _work_counter(q.device, stream).data_ptr(), B, Hq, Hkv, Sq, Sk, D, *_tma_strides(q),
        *_tma_strides(k), *_tma_strides(v), *o.stride()[:3], int(causal), int(window),
        float(softcap), 1.0 / math.sqrt(D) if scale is None else scale, stream)
    if err == -2:
        raise RuntimeError("flash_attention_sm90_fwd: the CUDA driver refused a TMA descriptor")
    _build.check(err, "flash_attention_sm90_fwd")
    flash_attention_wgmma_cuda.launches += 1
    return o


flash_attention_wgmma_cuda.launches = 0


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: int = 0,
                         softcap: float = 0.0, scale: float | None = None) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D), CUDA, bf16 or fp32, unit
    stride along D; D in ``HEAD_DIMS``; the logits are q.k times `scale`
    (1/sqrt(D) by default). Returns (B, Hq, Sq, D)."""
    _check("flash attention", q, k, v, (torch.bfloat16, torch.float32), HEAD_DIMS)
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    err = _entry("flash_attention_fwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), int(q.dtype == torch.bfloat16),
        B, Hq, Hkv, Sq, Sk, D, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *o.stride()[:3], int(causal), int(window), float(softcap),
        1.0 / math.sqrt(D) if scale is None else scale,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention_fwd")
    flash_attention_cuda.launches += 1
    return o


flash_attention_cuda.launches = 0


def attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, window: int = 0,
                   softcap: float = 0.0) -> torch.Tensor:
    """The op's attention on the card: calls ``wgmma_eligible`` accepts go to
    ``flash_attention_wgmma_cuda``, all others to ``flash_attention_cuda``;
    a head dim between the kernels' runs zero-padded to ``kernel_head_dim``
    at its own scale, the output sliced back."""
    D = q.shape[-1]
    Dk = kernel_head_dim(D)
    if Dk != D:
        q, k, v = (torch.nn.functional.pad(t, (0, Dk - D)) for t in (q, k, v))
    kernel = flash_attention_wgmma_cuda if wgmma_eligible(q, k, v) else flash_attention_cuda
    o = kernel(q, k, v, causal=causal, window=window, softcap=softcap,
               scale=1.0 / math.sqrt(D))
    return o if Dk == D else o[..., :D]


# ---------------------------------------------------------------------------
# backward (csrc/flash_attention_bwd.cu)
# ---------------------------------------------------------------------------

#: head dims of the backward kernel
BWD_HEAD_DIMS = (64, 128)


@functools.cache
def _bwd_entry():
    fn = _build.load("flash_attention_bwd").flash_attention_bwd
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 24
                   + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             o: torch.Tensor, do: torch.Tensor, *, causal: bool = True,
                             window: int = 0, softcap: float = 0.0):
    """(dq, dk, dv) of attention for the output gradient `do`: q, o, do
    (B, Hq, Sq, D) and k, v (B, Hkv, Sk, D), bf16 on one CUDA device, D in
    ``BWD_HEAD_DIMS``, any (batch, head, seq) strides with a unit stride
    along D; o the forward's output. Causal or full attention: a window or
    a softcap raises ``ValueError`` (no trainable config has one). dq, dk
    and dv keep q's and k's memory layouts. Three launches of
    ``csrc/flash_attention_bwd.cu`` (row statistics, dk and dv, dq) on the
    current stream; counts one launch."""
    if window or softcap:
        raise ValueError("flash_attention_bwd kernel takes no window or softcap "
                         f"(window={window}, softcap={softcap})")
    _check("flash_attention_bwd", q, k, v, (torch.bfloat16,), BWD_HEAD_DIMS)
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device \
                or t.stride(3) != 1:
            raise ValueError(f"flash_attention_bwd takes {name} of q's shape, dtype and "
                             f"device with a unit stride along D, got {tuple(t.shape)} "
                             f"{t.dtype} {t.device} strides {t.stride()}")
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    err = _bwd_entry()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), lse.data_ptr(), delta.data_ptr(), B, Hq, Hkv, Sq, Sk, D,
        *(s for t in (q, k, v, o, do, dq, dk, dv) for s in t.stride()[:3]), int(causal),
        1.0 / math.sqrt(D), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention_bwd")
    flash_attention_bwd_cuda.launches += 1
    return dq, dk, dv


flash_attention_bwd_cuda.launches = 0

"""Wrapper of the CUDA C++ WKV kernel (``csrc/wkv.cu``), which replaces
``repro/kernels/wkv/kernel.py::wkv_pallas``.

The source file carries the kernel's design note and its bound on an H100.
The wrapper checks what the kernel takes, allocates the output (and the final
state unless the caller gives ``state_out``), and launches on the current
stream. r, k, v and w come in the model's (B, T, H, N) layout with any batch,
time and head strides; ``state_out`` may be ``state0`` itself, which the
decode step uses to update its cache in place.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from .. import _build

HEAD_SIZES = (32, 64)


@functools.cache
def _entry():
    fn = _build.load("wkv").wkv_fwd
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong] * 12 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _state_arg(what: str, s: Optional[torch.Tensor], shape, dev) -> None:
    if s is None:
        return
    if s.shape != shape or s.dtype != torch.float32 or s.device != dev \
            or not s.is_contiguous():
        raise ValueError(f"wkv kernel takes {what} as a contiguous fp32 "
                         f"{shape} tensor on {dev}, got {tuple(s.shape)} "
                         f"{s.dtype} on {s.device}")


def wkv_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
             u: torch.Tensor, state0: Optional[torch.Tensor] = None,
             lengths: Optional[torch.Tensor] = None, *,
             state_out: Optional[torch.Tensor] = None):
    """r, k, v, w: (B, T, H, N) fp32 on one CUDA device, unit stride along
    N, N in (32, 64); u: (H, N) fp32; state0, state_out: (B, H, N, N)
    fp32 contiguous or None; lengths: (B,) int32 or None. Returns
    (out (B, T, H, N) contiguous, final state)."""
    if r.dim() != 4 or any(a.shape != r.shape for a in (k, v, w)):
        raise ValueError(f"wkv takes r, k, v, w of one (B,T,H,N) shape, got "
                         f"{[tuple(a.shape) for a in (r, k, v, w)]}")
    B, T, H, N = r.shape
    dev = r.device
    if dev.type != "cuda" or any(a.device != dev for a in (k, v, w, u)):
        raise ValueError("wkv kernel needs r, k, v, w, u on one CUDA device")
    if N not in HEAD_SIZES:
        raise ValueError(f"wkv kernel takes N in {HEAD_SIZES}, got {N}")
    if any(a.dtype != torch.float32 or a.stride(3) != 1 for a in (r, k, v, w)):
        raise ValueError("wkv kernel takes fp32 r, k, v, w with unit stride "
                         "along N")
    if u.shape != (H, N) or u.dtype != torch.float32:
        raise ValueError(f"wkv kernel takes u as fp32 ({H}, {N}), got "
                         f"{tuple(u.shape)} {u.dtype}")
    _state_arg("state0", state0, (B, H, N, N), dev)
    _state_arg("state_out", state_out, (B, H, N, N), dev)
    if state_out is not None and state0 is not None \
            and state_out.data_ptr() != state0.data_ptr() \
            and abs(state_out.data_ptr() - state0.data_ptr()) < state0.numel() * 4:
        raise ValueError("wkv kernel's state_out overlaps state0 without "
                         "being it")
    if lengths is not None:
        if lengths.shape != (B,) or lengths.dtype != torch.int32 \
                or lengths.device != dev:
            raise ValueError(f"wkv kernel takes lengths as ({B},) int32 on "
                             f"{dev}, got {tuple(lengths.shape)} "
                             f"{lengths.dtype} on {lengths.device}")
        lengths = lengths.contiguous()
    u = u.contiguous()
    out = torch.empty((B, T, H, N), dtype=torch.float32, device=dev)
    if state_out is None:
        state_out = torch.empty((B, H, N, N), dtype=torch.float32, device=dev)
    if B * H == 0:
        return out, state_out

    def ptr(t):
        return t.data_ptr() if t is not None else None

    strides = [s for a in (r, k, v, w) for s in a.stride()[:3]]
    err = _entry()(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                   u.data_ptr(), ptr(state0), ptr(lengths), out.data_ptr(),
                   state_out.data_ptr(), B, T, H, N, *strides,
                   torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "wkv_fwd")
    wkv_cuda.launches += 1
    return out, state_out


wkv_cuda.launches = 0

"""Wrapper of the CUDA C++ RG-LRU scan (``csrc/rglru.cu``), a kernel the port
adds for Griffin's recurrence, which the JAX package computes in XLA
(``repro/models/recurrent.py::_rglru_gates`` and the
``lax.associative_scan`` of ``rglru_apply``); eager PyTorch has no scan, and
a loop of T steps on the host would launch T rounds of small kernels.

The source carries the kernel's design note and its bound on an H100. The
wrapper checks what the kernel takes, allocates the outputs (and the final
state unless the caller gives ``h_out``), launches on the current stream and
counts its launches. ``h_out`` may be ``h0`` itself: the decode step updates
its cache in place.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from .. import _build


@functools.cache
def _entry():
    fn = _build.load("rglru").rglru_fwd
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _ptr(t):
    return t.data_ptr() if t is not None else None


def rglru_cuda(u: torch.Tensor, ga: torch.Tensor, gx: torch.Tensor, lam: torch.Tensor,
               gate: torch.Tensor, h0: Optional[torch.Tensor] = None,
               lengths: Optional[torch.Tensor] = None, *,
               h_out: Optional[torch.Tensor] = None):
    """u, gate: (B, T, d) bf16; ga, gx: (B, T, d) fp32; lam: (d,) fp32; h0,
    h_out: (B, d) fp32 or None; lengths: (B,) int32 or None; all contiguous
    on one CUDA device. Returns (``gate * h`` (B, T, d) fp32, h after each
    sequence's last real step (B, d) fp32), as ``ref.rglru_ref``."""
    if u.dim() != 3 or any(t.shape != u.shape for t in (ga, gx, gate)):
        raise ValueError(f"rglru takes u, ga, gx, gate of one (B,T,d) shape, got "
                         f"{[tuple(t.shape) for t in (u, ga, gx, gate)]}")
    B, T, d = u.shape
    dev = u.device
    ts = [u, ga, gx, lam, gate] + [t for t in (h0, lengths, h_out) if t is not None]
    if dev.type != "cuda" or any(t.device != dev for t in ts):
        raise ValueError("rglru kernel needs its tensors on one CUDA device")
    if u.dtype != torch.bfloat16 or gate.dtype != torch.bfloat16 or \
            any(t.dtype != torch.float32 for t in (ga, gx, lam)):
        raise ValueError(f"rglru kernel takes bf16 u and gate and fp32 ga, gx, lam, got "
                         f"{[t.dtype for t in (u, ga, gx, lam, gate)]}")
    if lam.shape != (d,):
        raise ValueError(f"rglru kernel takes lam of ({d},), got {tuple(lam.shape)}")
    for name, h in (("h0", h0), ("h_out", h_out)):
        if h is not None and (h.shape != (B, d) or h.dtype != torch.float32):
            raise ValueError(f"rglru kernel takes {name} as fp32 ({B}, {d}), got "
                             f"{tuple(h.shape)} {h.dtype}")
    if lengths is not None and (lengths.shape != (B,) or lengths.dtype != torch.int32):
        raise ValueError(f"rglru kernel takes lengths as ({B},) int32, got "
                         f"{tuple(lengths.shape)} {lengths.dtype}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("rglru kernel takes contiguous tensors")
    y = torch.empty((B, T, d), dtype=torch.float32, device=dev)
    if h_out is None:
        h_out = torch.empty((B, d), dtype=torch.float32, device=dev)
    if B * d == 0:
        return y, h_out
    err = _entry()(u.data_ptr(), ga.data_ptr(), gx.data_ptr(), lam.data_ptr(),
                   gate.data_ptr(), _ptr(h0), _ptr(lengths), y.data_ptr(), h_out.data_ptr(),
                   B, T, d, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "rglru_fwd")
    rglru_cuda.launches += 1
    return y, h_out


rglru_cuda.launches = 0

"""Wrappers of the CUDA C++ WKV kernels, which replace
``repro/kernels/wkv/kernel.py::wkv_pallas``: ``csrc/wkv_chunked.cu``
(``wkv_chunked_cuda``, the chunked-parallel form) for calls of more than one
step that ``chunked_eligible`` accepts, ``csrc/wkv.cu`` (``wkv_cuda``, one
step after another) for the decode step and the rest. ``csrc/wkv_bwd.cu``
(``wkv_bwd_cuda``) is the backward of a train step: the chunks run from the
end, from the segments' states the chunked forward writes when given
``s_seg``.

The source files carry the kernels' design notes and their bound on an H100.
Each wrapper checks what its kernel takes, allocates the output (and the final
state unless the caller gives ``state_out``), and launches on the current
stream. r, k, v and w come in the model's (B, T, H, N) layout with any batch,
time and head strides; ``state_out`` may be ``state0`` itself, which the
decode step uses to update its cache in place. The step-by-step kernel takes
N = 32, 64 and 128, the chunked one 32 and 64 (``COLUMN_SPLITS``): its
shared-memory layout and lane groups are laid out for at most 64, so every
call at N = 128 runs step by step. The op runs any other N up to 128 at the
next of these, zero-padded (``kernel_head_size``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from .. import _build
from .ref import CHUNK

HEAD_SIZES = (32, 64, 128)


def kernel_head_size(N: int) -> int:
    """The head size of ``HEAD_SIZES`` a call at N runs at: the least one at
    or above N. Above 128 raises."""
    for k in HEAD_SIZES:
        if N <= k:
            return k
    raise ValueError(f"wkv kernels take N up to {HEAD_SIZES[-1]}, got {N}")


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


def _checked(r, k, v, w, u, state0, lengths, state_out):
    """The checks both kernels share; returns (u, lengths, out, state_out)
    ready for the launch."""
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
    out = torch.empty((B, T, H, N), dtype=torch.float32, device=dev)
    if state_out is None:
        state_out = torch.empty((B, H, N, N), dtype=torch.float32, device=dev)
    return u.contiguous(), lengths, out, state_out


def _ptr(t):
    return t.data_ptr() if t is not None else None


def wkv_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
             u: torch.Tensor, state0: Optional[torch.Tensor] = None,
             lengths: Optional[torch.Tensor] = None, *,
             state_out: Optional[torch.Tensor] = None):
    """r, k, v, w: (B, T, H, N) fp32 on one CUDA device, unit stride along
    N, N in ``HEAD_SIZES``; u: (H, N) fp32; state0, state_out: (B, H, N, N)
    fp32 contiguous or None; lengths: (B,) int32 or None. Returns
    (out (B, T, H, N) contiguous, final state)."""
    u, lengths, out, state_out = _checked(r, k, v, w, u, state0, lengths, state_out)
    B, T, H, N = r.shape
    if B * H == 0:
        return out, state_out
    strides = [s for a in (r, k, v, w) for s in a.stride()[:3]]
    err = _entry()(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                   u.data_ptr(), _ptr(state0), _ptr(lengths), out.data_ptr(),
                   state_out.data_ptr(), B, T, H, N, *strides,
                   torch.cuda.current_stream(r.device).cuda_stream)
    _build.check(err, "wkv_fwd")
    wkv_cuda.launches += 1
    return out, state_out


wkv_cuda.launches = 0


# ---------------- the chunked kernel (csrc/wkv_chunked.cu) ----------------

#: value columns a block of the chunked kernel keeps, by head size, widest first
COLUMN_SPLITS = {64: (64, 32, 16), 32: (32, 16)}
#: a block's work beyond its columns' (the decays and the scores, which every
#: column slice of a head repeats), in columns' worth: about half the
#: per-chunk instructions of a 64-column block of csrc/wkv_chunked.cu
BLOCK_OVERHEAD = 32


@functools.cache
def _chunked_entry():
    fn = _build.load("wkv_chunked").wkv_chunked_fwd
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 12 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def chunked_eligible(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     w: torch.Tensor) -> bool:
    """Whether the chunked kernel takes a call: more than one step (the
    decode step, T = 1, stays on ``wkv_cuda``), r, k, v, w fp32 (B, T, H, N)
    with N in ``COLUMN_SPLITS`` (32 or 64), a unit stride along N, and 16-byte aligned
    bases and batch, time and head strides (of an axis longer than 1) that
    are multiples of 4 elements, as its 16-byte copies need. The model's
    (B, T, H, N) views qualify."""
    if r.dim() != 4 or r.shape[1] <= 1 or r.shape[3] not in COLUMN_SPLITS:
        return False
    return all(a.dtype == torch.float32 and a.shape == r.shape and a.stride(3) == 1
               and a.data_ptr() % 16 == 0
               and all(s % 4 == 0 for n, s in zip(a.shape[:3], a.stride()[:3]) if n > 1)
               for a in (r, k, v, w))


def column_split(B: int, H: int, N: int, sms: int) -> int:
    """Value columns a block keeps: the split whose busiest SM has the
    least work, ceil(blocks / sms) blocks of NC + BLOCK_OVERHEAD columns'
    worth each (the widest on a tie). The 8-slot wave of 64 heads of 64
    takes 64 (512 blocks), a batch-1 refill 32 (128 blocks, one an SM)."""
    return min(COLUMN_SPLITS[N],
               key=lambda nc: (-(-B * H * (N // nc) // sms) * (nc + BLOCK_OVERHEAD), -nc))


def wkv_chunked_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                     u: torch.Tensor, state0: Optional[torch.Tensor] = None,
                     lengths: Optional[torch.Tensor] = None, *,
                     state_out: Optional[torch.Tensor] = None,
                     columns: Optional[int] = None,
                     s_seg: Optional[torch.Tensor] = None):
    """The contract of ``wkv_cuda`` for calls ``chunked_eligible`` accepts
    (one it refuses raises: ``ops.wkv`` sends it to ``wkv_cuda``).
    ``columns``: the value columns a block keeps, one of
    ``COLUMN_SPLITS[N]``, or None for ``column_split``'s choice. Given
    ``s_seg``, a contiguous fp32 (B, H, ``segments(T)``, N, N) tensor, the
    launch also writes there the state at the start of each segment of
    ``SEGMENT_STEPS`` steps, which ``wkv_bwd_cuda`` takes (a train step,
    with no lengths; serving passes none). One launch; nothing is read back
    to the host."""
    u, lengths, out, state_out = _checked(r, k, v, w, u, state0, lengths, state_out)
    if not chunked_eligible(r, k, v, w):
        raise ValueError("wkv_chunked kernel takes T > 1 and 16-byte aligned "
                         "bases and strides (chunked_eligible)")
    B, T, H, N = r.shape
    if s_seg is not None:
        if lengths is not None:
            raise ValueError("wkv_chunked kernel writes s_seg for whole sequences: no "
                             "lengths (the backward takes none, ROADMAP B30)")
        _check_seg(s_seg, r)
    if columns is None:
        columns = column_split(B, H, N, torch.cuda.get_device_properties(
            r.device).multi_processor_count)
    if columns not in COLUMN_SPLITS[N]:
        raise ValueError(f"wkv_chunked kernel takes columns in "
                         f"{COLUMN_SPLITS[N]} at N={N}, got {columns}")
    if B * H == 0:
        return out, state_out
    strides = [s for a in (r, k, v, w) for s in a.stride()[:3]]
    err = _chunked_entry()(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                           u.data_ptr(), _ptr(state0), _ptr(lengths), out.data_ptr(),
                           state_out.data_ptr(), _ptr(s_seg), SEGMENT_STEPS // CHUNK,
                           B, T, H, N, columns, *strides,
                           torch.cuda.current_stream(r.device).cuda_stream)
    _build.check(err, "wkv_chunked_fwd")
    wkv_chunked_cuda.launches += 1
    return out, state_out


wkv_chunked_cuda.launches = 0


# ---------------- the backward (csrc/wkv_bwd.cu) ----------------

#: steps a segment of ``s_seg``: the backward rebuilds the states of a
#: segment's 4 chunks in shared memory; at rwkv6-7b's train shape (8, 512,
#: 64, 64) ``s_seg`` holds 67 MB a layer (every chunk's start would be 268)
SEGMENT_STEPS = 64
#: the head size of the backward kernel
BWD_HEAD_SIZE = 64


def segments(T: int) -> int:
    """The segments of ``SEGMENT_STEPS`` steps in T (the rows of an
    ``s_seg``)."""
    return -(-T // SEGMENT_STEPS)


def _check_seg(s_seg: torch.Tensor, r: torch.Tensor) -> None:
    B, T, H, N = r.shape
    want = (B, H, segments(T), N, N)
    if s_seg.shape != want or s_seg.dtype != torch.float32 or s_seg.device != r.device \
            or not s_seg.is_contiguous():
        raise ValueError(f"s_seg must be a contiguous fp32 {want} tensor on {r.device}, got "
                         f"{tuple(s_seg.shape)} {s_seg.dtype} {s_seg.device}")


@functools.cache
def _bwd_entry():
    fn = _build.load("wkv_bwd").wkv_bwd
    fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def wkv_bwd_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                 u: torch.Tensor, s_seg: torch.Tensor, dout: torch.Tensor,
                 dstate: Optional[torch.Tensor] = None, *, with_dstate0: bool = False):
    """Gradients (dr, dk, dv, dw, du, dstate0) of the chunked forward on
    ``csrc/wkv_bwd.cu``, as ``ref.wkv_bwd_ref`` computes them: r, k, v, w,
    u as the forward took them, over whole sequences (no lengths), `s_seg`
    the segments' states it wrote, dout the fp32 (B, T, H, N) gradient of
    its output and `dstate` that of its final state (None: zeros). r, k,
    v, w and dout contiguous and 16-byte aligned (strides the kernel does
    not read raise), N = ``BWD_HEAD_SIZE`` (other head sizes raise, ROADMAP
    B30). All fp32; dstate0 (B, H, N, N) with `with_dstate0`, else None.
    Two launches (the chunks from the end, then du's sum over the batch in
    a fixed order: the same bits run to run) on the current stream; counts
    one launch."""
    if r.dim() != 4 or r.device.type != "cuda":
        raise ValueError(f"wkv_bwd kernel takes (B, T, H, N) CUDA tensors, got "
                         f"{tuple(r.shape)} on {r.device}")
    B, T, H, N = r.shape
    if u.shape != (H, N) or u.dtype != torch.float32 or u.device != r.device:
        raise ValueError(f"wkv_bwd kernel takes u as fp32 ({H}, {N}) on {r.device}, got "
                         f"{tuple(u.shape)} {u.dtype} on {u.device}")
    if N != BWD_HEAD_SIZE:
        raise ValueError(f"wkv_bwd kernel takes N = {BWD_HEAD_SIZE}, got {N} (ROADMAP B30)")
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w), ("dout", dout)):
        if t.shape != r.shape or t.dtype != torch.float32 or t.device != r.device \
                or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"wkv_bwd kernel takes {name} as a contiguous 16-byte aligned "
                             f"fp32 {tuple(r.shape)} tensor, got {tuple(t.shape)} {t.dtype} "
                             f"(contiguous: {t.is_contiguous()})")
    _check_seg(s_seg, r)
    _state_arg("dstate", dstate, (B, H, N, N), r.device)
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du = torch.zeros((H, N), dtype=torch.float32, device=r.device)
    dstate0 = torch.empty((B, H, N, N), dtype=torch.float32, device=r.device) \
        if with_dstate0 else None
    if B * T * H == 0:
        if dstate0 is not None:
            dstate0.zero_()
            if dstate is not None:
                dstate0.copy_(dstate)
        return dr, dk, dv, dw, du, dstate0
    u = u.contiguous()
    part = torch.empty((B, H, N), dtype=torch.float32, device=r.device)
    err = _bwd_entry()(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                       u.data_ptr(), s_seg.data_ptr(), dout.data_ptr(),
                       _ptr(dstate), dr.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                       dw.data_ptr(), _ptr(dstate0), part.data_ptr(), du.data_ptr(),
                       B, T, H, N, SEGMENT_STEPS // CHUNK,
                       torch.cuda.current_stream(r.device).cuda_stream)
    _build.check(err, "wkv_bwd")
    wkv_bwd_cuda.launches += 1
    return dr, dk, dv, dw, du, dstate0


wkv_bwd_cuda.launches = 0

"""Wrappers of the CUDA C++ RG-LRU scans, kernels the port adds for Griffin's
recurrence, which the JAX package computes in XLA
(``repro/models/recurrent.py::_rglru_gates`` and the
``lax.associative_scan`` of ``rglru_apply``); eager PyTorch has no scan, and
a loop of T steps on the host would launch T rounds of small kernels.
``csrc/rglru_chunked.cu`` (``rglru_chunked_cuda``, a chunked scan over T)
takes the calls that ``picks_chunked`` names (more than one step),
``csrc/rglru.cu`` (``rglru_cuda``, one thread a channel, step after step)
the decode step and the rest. ``csrc/rglru_bwd.cu`` (``rglru_bwd_cuda``) is
the backward of a train step: the chunked scan run from the end, from the
segments' states the chunked forward writes when given ``h_seg``.

The sources carry the kernels' design notes and their bound on an H100. Each
wrapper checks what its kernel takes, allocates the outputs (and the final
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

#: steps a segment of the chunked kernel, a tile being 16 segments
SEGMENT_STEPS = (4, 8)
#: from this many steps a call runs at 8 steps a segment, below it at 4
LONG_T = 1024


@functools.cache
def _entry():
    fn = _build.load("rglru").rglru_fwd
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _chunked_entry():
    fn = _build.load("rglru_chunked").rglru_chunked_fwd
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _ptr(t):
    return t.data_ptr() if t is not None else None


def _checked(u, ga, gx, lam, gate, h0, lengths, h_out):
    """The checks both kernels share; returns (y, h_out) ready for the
    launch."""
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
    return y, h_out


def rglru_cuda(u: torch.Tensor, ga: torch.Tensor, gx: torch.Tensor, lam: torch.Tensor,
               gate: torch.Tensor, h0: Optional[torch.Tensor] = None,
               lengths: Optional[torch.Tensor] = None, *,
               h_out: Optional[torch.Tensor] = None):
    """u, gate: (B, T, d) bf16; ga, gx: (B, T, d) fp32; lam: (d,) fp32; h0,
    h_out: (B, d) fp32 or None; lengths: (B,) int32 or None; all contiguous
    on one CUDA device. Returns (``gate * h`` (B, T, d) fp32, h after each
    sequence's last real step (B, d) fp32), as ``ref.rglru_ref``."""
    y, h_out = _checked(u, ga, gx, lam, gate, h0, lengths, h_out)
    B, T, d = u.shape
    if B * d == 0:
        return y, h_out
    err = _entry()(u.data_ptr(), ga.data_ptr(), gx.data_ptr(), lam.data_ptr(),
                   gate.data_ptr(), _ptr(h0), _ptr(lengths), y.data_ptr(), h_out.data_ptr(),
                   B, T, d, torch.cuda.current_stream(u.device).cuda_stream)
    _build.check(err, "rglru_fwd")
    rglru_cuda.launches += 1
    return y, h_out


rglru_cuda.launches = 0


# ---------------- the chunked kernel (csrc/rglru_chunked.cu) ----------------

def chunked_eligible(u: torch.Tensor, ga: torch.Tensor, gx: torch.Tensor,
                     gate: torch.Tensor) -> bool:
    """Whether the chunked kernel can take a call: u, ga, gx, gate of one
    contiguous (B, T, d) shape with d a multiple of 8 and 16-byte aligned
    bases, as its 16-byte copies of a 16-channel tile's rows need. The
    model's tensors qualify at every width of a served config."""
    if u.dim() != 3 or u.shape[2] % 8:
        return False
    return all(t.shape == u.shape and t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in (u, ga, gx, gate))


def picks_chunked(u: torch.Tensor, ga: torch.Tensor, gx: torch.Tensor,
                  gate: torch.Tensor) -> bool:
    """The op's route: the chunked kernel for a call of more than one step
    it can take, ``rglru_cuda`` for the decode step (T = 1, where both are
    launch-bound and the step-by-step kernel is the faster, ``PERF.md``)
    and for the rest."""
    return u.dim() == 3 and u.shape[1] > 1 and chunked_eligible(u, ga, gx, gate)


def segment_steps(T: int) -> int:
    """Steps a segment of the chunked kernel at T steps: 8 from ``LONG_T``
    on (the ring phase's 2304-token prefill), where a tile of 128 steps
    halves the tiles' barriers and folds, else 4 (the served wave and the
    refills), where a tile of 64 wastes less past each sequence's last step
    and a block's smaller shared memory lets four share an SM."""
    return 8 if T >= LONG_T else 4


def segments(T: int, steps: int) -> int:
    """The segments of the chunked kernels at T steps and `steps` a segment:
    whole tiles of 16 segments (the rows of an ``h_seg``)."""
    return -(-T // (16 * steps)) * 16


def rglru_chunked_cuda(u: torch.Tensor, ga: torch.Tensor, gx: torch.Tensor,
                       lam: torch.Tensor, gate: torch.Tensor,
                       h0: Optional[torch.Tensor] = None,
                       lengths: Optional[torch.Tensor] = None, *,
                       h_out: Optional[torch.Tensor] = None,
                       steps: Optional[int] = None,
                       h_seg: Optional[torch.Tensor] = None):
    """The contract of ``rglru_cuda`` for calls ``chunked_eligible`` accepts
    (one it refuses raises); ``ops.rglru`` sends it the calls
    ``picks_chunked`` names. ``steps``: the steps of a segment, one of
    ``SEGMENT_STEPS``, or None for ``segment_steps``' choice. Given
    ``h_seg``, a contiguous fp32 (B, ``segments(T, steps)``, d) tensor, the
    launch also writes there the state each segment starts from, which
    ``rglru_bwd_cuda`` takes (a train step; serving passes none). One
    launch; nothing is read back to the host."""
    y, h_out = _checked(u, ga, gx, lam, gate, h0, lengths, h_out)
    if not chunked_eligible(u, ga, gx, gate):
        raise ValueError("rglru_chunked kernel takes d a multiple of 8 and 16-byte "
                         "aligned bases (chunked_eligible)")
    B, T, d = u.shape
    steps = segment_steps(T) if steps is None else steps
    if steps not in SEGMENT_STEPS:
        raise ValueError(f"rglru_chunked kernel takes steps in {SEGMENT_STEPS}, got {steps}")
    if h_seg is not None:
        _check_seg(h_seg, u, steps)
    if B * d == 0:
        return y, h_out
    err = _chunked_entry()(u.data_ptr(), ga.data_ptr(), gx.data_ptr(), lam.data_ptr(),
                           gate.data_ptr(), _ptr(h0), _ptr(lengths), y.data_ptr(),
                           h_out.data_ptr(), _ptr(h_seg), B, T, d, steps,
                           torch.cuda.current_stream(u.device).cuda_stream)
    _build.check(err, "rglru_chunked_fwd")
    rglru_chunked_cuda.launches += 1
    return y, h_out


rglru_chunked_cuda.launches = 0


# ---------------- the backward (csrc/rglru_bwd.cu) ----------------

def _check_seg(h_seg: torch.Tensor, u: torch.Tensor, steps: int) -> None:
    B, T, d = u.shape
    want = (B, segments(T, steps), d)
    if h_seg.shape != want or h_seg.dtype != torch.float32 or h_seg.device != u.device \
            or not h_seg.is_contiguous():
        raise ValueError(f"h_seg must be a contiguous fp32 {want} tensor on {u.device}, got "
                         f"{tuple(h_seg.shape)} {h_seg.dtype} {h_seg.device}")


@functools.cache
def _bwd_entry():
    fn = _build.load("rglru_bwd").rglru_bwd
    fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def rglru_bwd_cuda(u: torch.Tensor, ga: torch.Tensor, gx: torch.Tensor, lam: torch.Tensor,
                   gate: torch.Tensor, h_seg: torch.Tensor, dy: torch.Tensor,
                   dh_last: Optional[torch.Tensor] = None, *,
                   steps: Optional[int] = None, with_dh0: bool = False):
    """Gradients (du, dga, dgx, dlam, dgate, dh0) of the chunked forward on
    ``csrc/rglru_bwd.cu``, as ``ref.rglru_bwd_ref`` computes them: u, ga,
    gx, lam, gate as the forward took them (no lengths), `h_seg` the
    segments' states it wrote at `steps` a segment (None: ``segment_steps``'
    choice, as the forward's), dy the fp32 (B, T, d) gradient of its output
    and `dh_last` that of its final state (None: zeros). du and dgate bf16,
    the rest fp32; dh0 (B, d) with `with_dh0`, else None. Two launches (the
    scan from the end, then dlam's sum over the batch in a fixed order: the
    same bits run to run) on the current stream; counts one launch."""
    _checked(u, ga, gx, lam, gate, None, None, None)
    if not chunked_eligible(u, ga, gx, gate):
        raise ValueError("rglru_bwd kernel takes d a multiple of 8 and 16-byte aligned bases "
                         "(chunked_eligible)")
    B, T, d = u.shape
    steps = segment_steps(T) if steps is None else steps
    if steps not in SEGMENT_STEPS:
        raise ValueError(f"rglru_bwd kernel takes steps in {SEGMENT_STEPS}, got {steps}")
    _check_seg(h_seg, u, steps)
    if dy.shape != u.shape or dy.dtype != torch.float32 or dy.device != u.device \
            or not dy.is_contiguous() or dy.data_ptr() % 16:
        raise ValueError(f"rglru_bwd kernel takes dy as a contiguous 16-byte aligned fp32 "
                         f"{tuple(u.shape)} tensor, got {tuple(dy.shape)} {dy.dtype}")
    if dh_last is not None and (dh_last.shape != (B, d) or dh_last.dtype != torch.float32
                                or dh_last.device != u.device or not dh_last.is_contiguous()):
        raise ValueError(f"rglru_bwd kernel takes dh_last as a contiguous fp32 ({B}, {d}) "
                         f"tensor, got {tuple(dh_last.shape)} {dh_last.dtype}")
    du, dgate = torch.empty_like(u), torch.empty_like(gate)
    dga, dgx = torch.empty_like(ga), torch.empty_like(gx)
    dlam = torch.zeros_like(lam)
    dh0 = torch.zeros((B, d), dtype=torch.float32, device=u.device) if with_dh0 else None
    if B * T * d == 0:
        if dh0 is not None and dh_last is not None:
            dh0.copy_(dh_last)
        return du, dga, dgx, dlam, dgate, dh0
    part = torch.empty((B, d), dtype=torch.float32, device=u.device)
    err = _bwd_entry()(u.data_ptr(), ga.data_ptr(), gx.data_ptr(), lam.data_ptr(),
                       gate.data_ptr(), h_seg.data_ptr(), dy.data_ptr(), _ptr(dh_last),
                       du.data_ptr(), dga.data_ptr(), dgx.data_ptr(), dgate.data_ptr(),
                       _ptr(dh0), part.data_ptr(), dlam.data_ptr(), B, T, d, steps,
                       torch.cuda.current_stream(u.device).cuda_stream)
    _build.check(err, "rglru_bwd")
    rglru_bwd_cuda.launches += 1
    return du, dga, dgx, dlam, dgate, dh0


rglru_bwd_cuda.launches = 0

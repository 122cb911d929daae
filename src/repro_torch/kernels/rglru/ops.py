"""Public RG-LRU scan op: a CUDA kernel for a CUDA tensor (the chunked scan
for a call ``kernel.picks_chunked`` names, of more than one step,
else the step-by-step one), the plain version for a CPU tensor.

The op is differentiable: where grad mode is on and an input requires a
gradient, it runs as ``RGLRUFn``, whose forward on the card is the chunked
kernel also writing each segment's starting state, and whose backward is
``rglru_bwd_cuda`` on the card and ``rglru_bwd_ref`` on the CPU. Otherwise
(serving) it calls the forward directly and builds no graph."""
from __future__ import annotations

from typing import Optional

import torch

from ...device import runs_plain
from . import kernel
from .ref import rglru_bwd_ref, rglru_ref


class RGLRUFn(torch.autograd.Function):
    """The RG-LRU scan with its hand-written backward, for whole sequences
    (a train step passes no lengths; the backward refuses them). On the
    card it saves the inputs and the segments' states ``h_seg``, from which
    the backward runs each segment again; on the CPU the inputs alone."""

    @staticmethod
    def forward(ctx, u, ga, gx, lam, gate, h0, lengths):
        ctx.set_materialize_grads(False)   # an unused final state passes no gradient
        ctx.lengths = lengths is not None
        ctx.has_h0 = h0 is not None
        if runs_plain(u):
            y, h = rglru_ref(u, ga, gx, lam, gate, h0, lengths)
            ctx.save_for_backward(u, ga, gx, lam, gate, h0)
            return y, h
        args = [t.contiguous() for t in (u, ga, gx, lam, gate)]
        B, T, d = u.shape
        ctx.steps = kernel.segment_steps(T)
        h_seg = torch.empty((B, kernel.segments(T, ctx.steps), d), dtype=torch.float32,
                            device=u.device)
        y, h = kernel.rglru_chunked_cuda(*args, h0, lengths, steps=ctx.steps, h_seg=h_seg)
        ctx.save_for_backward(*args, h_seg)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh_last):
        if ctx.lengths:
            raise ValueError("the RG-LRU backward takes whole sequences: no lengths")
        dy = torch.zeros_like(dy) if dy is None else dy.float().contiguous()
        if runs_plain(dy):
            u, ga, gx, lam, gate, h0 = ctx.saved_tensors
            grads = rglru_bwd_ref(u, ga, gx, lam, gate, h0, dy, dh_last)
        else:
            u, ga, gx, lam, gate, h_seg = ctx.saved_tensors
            grads = kernel.rglru_bwd_cuda(
                u, ga, gx, lam, gate, h_seg, dy,
                None if dh_last is None else dh_last.float().contiguous(),
                steps=ctx.steps, with_dh0=ctx.has_h0)
        return (*grads, None)


def rglru(u: torch.Tensor, ga: torch.Tensor, gx: torch.Tensor, lam: torch.Tensor,
          gate: torch.Tensor, h0: Optional[torch.Tensor] = None,
          lengths: Optional[torch.Tensor] = None, *,
          h_out: Optional[torch.Tensor] = None):
    """u, gate: (B, T, d) bf16; ga, gx: (B, T, d) fp32; lam: (d,); h0: (B, d)
    fp32 or None (zeros); lengths: (B,) int32 or None. Returns (``gate * h``
    (B, T, d) fp32, h after each sequence's last real step (B, d)). With
    ``h_out`` the final h is written into it, in place, and returned; it may
    be ``h0`` itself. Where a gradient is due it runs as ``RGLRUFn``, which
    takes no ``h_out``."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (u, ga, gx, lam, gate, h0)):
        if h_out is not None:
            raise ValueError("a differentiable rglru call takes no h_out")
        return RGLRUFn.apply(u, ga, gx, lam, gate, h0, lengths)
    if runs_plain(u):
        y, h = rglru_ref(u, ga, gx, lam, gate, h0, lengths)
        return y, h if h_out is None else h_out.copy_(h)
    args = (u.contiguous(), ga.contiguous(), gx.contiguous(), lam.contiguous(),
            gate.contiguous())
    launch = kernel.rglru_chunked_cuda if kernel.picks_chunked(*args[:3], args[4]) else \
        kernel.rglru_cuda
    return launch(*args, h0, lengths, h_out=h_out)

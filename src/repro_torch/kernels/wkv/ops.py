"""Public WKV op: a CUDA kernel for a CUDA tensor (the chunked one for a
call of more than one step that ``kernel.chunked_eligible`` accepts, else
the step-by-step one), the plain version for a CPU tensor.

The op is differentiable: where grad mode is on and an input requires a
gradient, it runs as ``WKVFn``, whose forward on the card is the chunked
kernel also writing each segment's starting state, and whose backward is
``wkv_bwd_cuda`` on the card and ``wkv_bwd_ref`` on the CPU. Otherwise
(serving) it calls the forward directly and builds no graph."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ...device import runs_plain
from . import kernel
from .ref import wkv_bwd_ref, wkv_ref


class WKVFn(torch.autograd.Function):
    """The WKV recurrence with its hand-written backward, for whole
    sequences (a train step passes no lengths; the backward refuses them).
    On the card it saves the inputs and the segments' states ``s_seg``,
    from which the backward rebuilds each chunk's; on the CPU the inputs
    alone. The card takes N = ``kernel.BWD_HEAD_SIZE`` (64, rwkv6's) alone
    and refuses any other with ``ValueError`` (ROADMAP B30)."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state0, lengths):
        ctx.set_materialize_grads(False)   # an unused output passes no gradient
        ctx.lengths = lengths is not None
        ctx.has_state0 = state0 is not None
        if runs_plain(r):
            out, state = wkv_ref(r, k, v, w, u, state0, lengths)
            ctx.save_for_backward(r, k, v, w, u, state0)
            return out, state
        B, T, H, N = r.shape
        if N != kernel.BWD_HEAD_SIZE:
            raise ValueError(f"a differentiable wkv call on the card takes N = "
                             f"{kernel.BWD_HEAD_SIZE}, got {N} (ROADMAP B30)")
        args = [t.contiguous() for t in (r, k, v, w, u)]
        s_seg = None if lengths is not None else torch.empty(
            (B, H, kernel.segments(T), N, N), dtype=torch.float32, device=r.device)
        out, state = kernel.wkv_chunked_cuda(*args, state0, lengths, s_seg=s_seg)
        ctx.save_for_backward(*args, s_seg)
        return out, state

    @staticmethod
    def backward(ctx, dout, dstate):
        if ctx.lengths:
            raise ValueError("the wkv backward takes whole sequences: no lengths")
        r = ctx.saved_tensors[0]
        dout = torch.zeros_like(r) if dout is None else dout.float().contiguous()
        if runs_plain(dout):
            grads = wkv_bwd_ref(*ctx.saved_tensors, dout, dstate)
        else:
            r, k, v, w, u, s_seg = ctx.saved_tensors
            grads = kernel.wkv_bwd_cuda(
                r, k, v, w, u, s_seg, dout,
                None if dstate is None else dstate.float().contiguous(),
                with_dstate0=ctx.has_state0)
        return (*grads, None)


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
        u: torch.Tensor, state0: Optional[torch.Tensor] = None,
        lengths: Optional[torch.Tensor] = None, *,
        state_out: Optional[torch.Tensor] = None):
    """r, k, v, w: (B, T, H, N) fp32; u: (H, N); state0: (B, H, N, N) or None
    (zeros); lengths: (B,) int32 or None. Returns (out (B, T, H, N), final
    state (B, H, N, N)). With ``state_out`` the final state is written into
    it, in place, and returned; it may be ``state0`` itself. Where a
    gradient is due it runs as ``WKVFn``, which takes no ``state_out``.

    On the card a head size N below 128 other than 32 and 64 runs at the
    next of (32, 64, 128) (``kernel.kernel_head_size``), zero-padded: r, k,
    v and u padded with 0 and w with 1, the state with zero rows and
    columns, which stay 0, so the sliced output and state are exact. The
    card refuses, with ``ValueError``, what the kernels do not take and the
    plain version computes on the CPU: N above 128, and inputs other than
    fp32."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (r, k, v, w, u, state0)):
        if state_out is not None:
            raise ValueError("a differentiable wkv call takes no state_out")
        return WKVFn.apply(r, k, v, w, u, state0, lengths)
    if runs_plain(r):
        out, state = wkv_ref(r, k, v, w, u, state0, lengths)
        return out, state if state_out is None else state_out.copy_(state)
    N = r.shape[-1]
    Nk = kernel.kernel_head_size(N)
    if Nk != N:
        pad = (0, Nk - N)
        s0 = None if state0 is None else F.pad(state0, pad + pad)
        out, state = wkv(*(F.pad(a, pad) for a in (r, k, v)), F.pad(w, pad, value=1.0),
                         F.pad(u, pad), s0, lengths)
        state = state[..., :N, :N]
        return out[..., :N], state if state_out is None else state_out.copy_(state)
    launch = kernel.wkv_chunked_cuda if kernel.chunked_eligible(r, k, v, w) else \
        kernel.wkv_cuda
    return launch(r, k, v, w, u, state0, lengths, state_out=state_out)

"""SwiGLU gate ``silu(g) * u`` as a Triton kernel for Hopper.

Replaces ``repro/kernels/gelu/kernel.py::silu_mul_pallas``: elementwise
``g * sigmoid(g) * u`` computed in fp32 and rounded once to the input dtype.
(The tanh GELU of the same TPU module, ``gelu_pallas``, is not ported yet.)

Bound on an H100: bytes. Two reads and one write per element against a few
fp32 operations.

Design: a flat pass over the contiguous elements, BLOCK elements per program
with masked loads at the ragged end; g and u are read once and the result
written once, the intermediate ``silu(g)`` never reaches device memory. A
fused elementwise pass is where Triton reaches the card's memory rate with
nothing to hand-tune, hence Triton and not CUDA C++.
"""

import functools

import torch

BLOCK = 4096


@functools.cache
def _kernel():
    """Compile at first use: triton exists only where a card is."""
    global tl
    import triton
    import triton.language as tl

    @triton.jit(do_not_specialize=["n"])
    def silu_mul_fwd(g_ptr, u_ptr, o_ptr, n, BLOCK: tl.constexpr):
        offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
        mask = offs < n
        g = tl.load(g_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        u = tl.load(u_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        y = g * tl.sigmoid(g) * u
        tl.store(o_ptr + offs, y.to(o_ptr.dtype.element_ty), mask=mask)

    return triton, silu_mul_fwd


def silu_mul_triton(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """g, u: contiguous CUDA tensors of one shape and dtype (bf16 or fp32)."""
    if g.shape != u.shape or g.dtype != u.dtype:
        raise ValueError(f"silu_mul takes g and u of one shape and dtype, got "
                         f"{tuple(g.shape)} {g.dtype} and {tuple(u.shape)} {u.dtype}")
    if g.device.type != "cuda" or u.device != g.device:
        raise ValueError("silu_mul kernel needs g and u on one CUDA device")
    if g.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"silu_mul kernel takes bf16/fp32, got {g.dtype}")
    if not (g.is_contiguous() and u.is_contiguous()):
        raise ValueError("silu_mul kernel takes contiguous g and u")
    out = torch.empty_like(g)
    n = g.numel()
    if n == 0:
        return out
    triton, kern = _kernel()
    kern[(triton.cdiv(n, BLOCK),)](g, u, out, n, BLOCK=BLOCK, num_warps=8)
    silu_mul_triton.launches += 1
    return out


silu_mul_triton.launches = 0

"""RMSNorm as a Triton kernel for Hopper.

Replaces ``repro/kernels/rmsnorm/kernel.py::rmsnorm_pallas``:
``x * rsqrt(mean(x^2) + eps) * g`` over the last axis of ``x (R, C)``, fp32
statistics, output in the input dtype.

Bound on an H100: bytes. Each element is read once and written once with a
handful of fp32 operations, about 2 operations per byte in bf16, far below
the ~295 at which arithmetic would be the limit.

Design: one program normalises ROWS whole rows held in registers
(``BLOCK_C = next_pow2(C)``, masked past C), so each element crosses device
memory once each way, as in the TPU kernel's (br, C) VMEM block. ROWS grows
as C shrinks so a program always moves a few KiB: 2 rows at C=2048 (the
model width), 32 at C=128 (qk-norm over heads). Masked block loads give the
same memory rate as a hand-written CUDA kernel here and there is no
tensor-core or shared-memory design to make, which is why this kernel is
Triton and not CUDA C++.
"""

import functools

import torch


@functools.cache
def _kernel():
    """Compile at first use: triton exists only where a card is."""
    global tl
    import triton
    import triton.language as tl

    @triton.jit(do_not_specialize=["R"])
    def rmsnorm_fwd(x_ptr, g_ptr, o_ptr, R, C, stride_x, stride_o, eps,
                    ROWS: tl.constexpr, BLOCK_C: tl.constexpr):
        rows = tl.program_id(0) * ROWS + tl.arange(0, ROWS)
        cols = tl.arange(0, BLOCK_C)
        mask = (rows[:, None] < R) & (cols[None, :] < C)
        x = tl.load(x_ptr + rows[:, None] * stride_x + cols[None, :],
                    mask=mask, other=0.0).to(tl.float32)
        var = tl.sum(x * x, axis=1) / C
        rstd = 1.0 / tl.sqrt(var + eps)
        g = tl.load(g_ptr + cols, mask=cols < C, other=0.0).to(tl.float32)
        y = x * rstd[:, None] * g[None, :]
        tl.store(o_ptr + rows[:, None] * stride_o + cols[None, :],
                 y.to(o_ptr.dtype.element_ty), mask=mask)

    return triton, rmsnorm_fwd


def rmsnorm_triton(x: torch.Tensor, g: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """x: (R, C) CUDA tensor, bf16 or fp32, unit stride along C; g: (C,)."""
    if x.dim() != 2 or g.shape != (x.shape[1],):
        raise ValueError(f"rmsnorm takes x (R, C) and g (C,), got "
                         f"{tuple(x.shape)} and {tuple(g.shape)}")
    if x.device.type != "cuda" or g.device != x.device:
        raise ValueError("rmsnorm kernel needs x and g on one CUDA device")
    if x.dtype not in (torch.bfloat16, torch.float32) or x.stride(1) != 1:
        raise ValueError(f"rmsnorm kernel takes bf16/fp32 rows with unit "
                         f"stride, got {x.dtype} with strides {x.stride()}")
    g = g.contiguous()
    R, C = x.shape
    out = torch.empty((R, C), dtype=x.dtype, device=x.device)
    if R == 0:
        return out
    triton, kern = _kernel()
    block_c = triton.next_power_of_2(C)
    rows = max(1, min(64, 4096 // block_c))
    kern[(triton.cdiv(R, rows),)](x, g, out, R, C, x.stride(0), out.stride(0),
                                  eps, ROWS=rows, BLOCK_C=block_c,
                                  num_warps=4 if block_c <= 2048 else 8)
    rmsnorm_triton.launches += 1
    return out


rmsnorm_triton.launches = 0

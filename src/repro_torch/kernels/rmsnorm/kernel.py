"""RMSNorm and LayerNorm as Triton kernels for Hopper.

Replace ``repro/kernels/rmsnorm/kernel.py::rmsnorm_pallas`` and
``::layernorm_pallas`` over the last axis of ``x (R, C)``, fp32 statistics,
output in the input dtype:

  * RMSNorm ``x * rsqrt(mean(x^2) + eps) * g``;
  * LayerNorm ``(x - mu) * rsqrt(mean((x - mu)^2) + eps) * g + b``, the
    variance taken from the centred row as the Pallas body takes it, never
    as ``E[x^2] - mu^2``, which cancels badly at gpt3's C=12288.

Bound on an H100: bytes. Each element is read once and written once with a
handful of fp32 operations, about 2-3 operations per byte in bf16, far below
the ~295 at which arithmetic would be the limit.

Design: one program normalises ROWS rows (``BLOCK_C = next_pow2(C)``,
masked past C), so each element crosses device memory once each way, as in
the TPU kernel's (br, C) VMEM block. ROWS grows as C shrinks so a program
always moves a few KiB: 2 rows at C=2048 (the model width), 32 at C=128
(qk-norm over heads). RMSNorm holds its rows whole in registers. LayerNorm
takes a row in chunks of at most CHUNK_C columns: a first pass takes each
chunk's mean and centred sum of squares and merges them (Chan's parallel
update: the two-pass statistic of the whole row, never ``E[x^2] - mu^2``), a
second pass normalises chunk by chunk, reading the row again from L1/L2, so
device memory still sees each element once each way. A row of up to CHUNK_C
columns is one chunk. A whole 16384-wide row (gpt3's C=12288) held in
registers needs 16 warps at 122 registers a thread, one block per SM, which
ran at 43% of the bound and behind ``F.layer_norm`` (0.1408 ms against
0.1197 ms at (4096, 12288) bf16, ``chip_smoke.py`` on an NVIDIA H100 80GB
HBM3 at 700 W); chunks of 4096 at 8 warps leave room for several blocks per
SM. Masked block loads give the same memory rate as a hand-written CUDA
kernel here and there is no tensor-core or shared-memory design to make,
which is why these kernels are Triton and not CUDA C++.
"""

import functools

import torch


@functools.cache
def _kernels():
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

    @triton.jit(do_not_specialize=["R"])
    def layernorm_fwd(x_ptr, g_ptr, b_ptr, o_ptr, R, C, stride_x, stride_o,
                      eps, ROWS: tl.constexpr, BLOCK_C: tl.constexpr,
                      N_CHUNKS: tl.constexpr):
        rows = tl.program_id(0) * ROWS + tl.arange(0, ROWS)
        row_ok = rows[:, None] < R
        # pass 1: each chunk's mean and centred sum of squares, merged
        mean = tl.zeros((ROWS,), dtype=tl.float32)
        m2 = tl.zeros((ROWS,), dtype=tl.float32)
        for k in range(N_CHUNKS):
            cols = k * BLOCK_C + tl.arange(0, BLOCK_C)
            mask = row_ok & (cols[None, :] < C)
            x = tl.load(x_ptr + rows[:, None] * stride_x + cols[None, :],
                        mask=mask, other=0.0).to(tl.float32)
            n_k = tl.minimum(C - k * BLOCK_C, BLOCK_C).to(tl.float32)
            mean_k = tl.sum(x, axis=1) / n_k
            xc = tl.where(mask, x - mean_k[:, None], 0.0)
            count = k * BLOCK_C * 1.0               # columns merged so far
            total = count + n_k
            delta = mean_k - mean
            mean = mean + delta * (n_k / total)
            m2 = m2 + tl.sum(xc * xc, axis=1) + delta * delta * (count * n_k / total)
        rstd = 1.0 / tl.sqrt(m2 / C + eps)
        # pass 2: normalise chunk by chunk, the row read again (from L1/L2)
        for k in range(N_CHUNKS):
            cols = k * BLOCK_C + tl.arange(0, BLOCK_C)
            mask = row_ok & (cols[None, :] < C)
            x = tl.load(x_ptr + rows[:, None] * stride_x + cols[None, :],
                        mask=mask, other=0.0).to(tl.float32)
            g = tl.load(g_ptr + cols, mask=cols < C, other=0.0).to(tl.float32)
            b = tl.load(b_ptr + cols, mask=cols < C, other=0.0).to(tl.float32)
            y = (x - mean[:, None]) * rstd[:, None] * g[None, :] + b[None, :]
            tl.store(o_ptr + rows[:, None] * stride_o + cols[None, :],
                     y.to(o_ptr.dtype.element_ty), mask=mask)

    return triton, rmsnorm_fwd, layernorm_fwd


CHUNK_C = 4096   # a wider LayerNorm row goes in chunks of this many columns


def launch_params(C: int) -> dict:
    """Rows per program, block width and warps for whole rows of C elements."""
    block_c = 1 << max(C - 1, 0).bit_length()
    return {"ROWS": max(1, min(64, 4096 // block_c)), "BLOCK_C": block_c,
            "num_warps": 4 if block_c <= 2048 else 8}


def layernorm_params(C: int) -> dict:
    """``launch_params`` of a row up to CHUNK_C wide, one chunk; a wider row
    in N_CHUNKS chunks of CHUNK_C, one row per program."""
    if C <= CHUNK_C:
        return {**launch_params(C), "N_CHUNKS": 1}
    return {**launch_params(CHUNK_C), "N_CHUNKS": -(-C // CHUNK_C)}


def _check_rows(what: str, x: torch.Tensor, *params: torch.Tensor) -> None:
    if x.dim() != 2 or any(p.shape != (x.shape[1],) for p in params):
        raise ValueError(f"{what} takes x (R, C) and parameters (C,), got "
                         f"{tuple(x.shape)} and {[tuple(p.shape) for p in params]}")
    if x.device.type != "cuda" or any(p.device != x.device for p in params):
        raise ValueError(f"{what} kernel needs x and its parameters on one "
                         "CUDA device")
    if x.dtype not in (torch.bfloat16, torch.float32) or x.stride(1) != 1:
        raise ValueError(f"{what} kernel takes bf16/fp32 rows with unit "
                         f"stride, got {x.dtype} with strides {x.stride()}")


def rmsnorm_triton(x: torch.Tensor, g: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """x: (R, C) CUDA tensor, bf16 or fp32, unit stride along C; g: (C,)."""
    _check_rows("rmsnorm", x, g)
    g = g.contiguous()
    R, C = x.shape
    out = torch.empty((R, C), dtype=x.dtype, device=x.device)
    if R == 0:
        return out
    triton, kern, _ = _kernels()
    p = launch_params(C)
    rmsnorm_triton.compiled = kern[(triton.cdiv(R, p["ROWS"]),)](
        x, g, out, R, C, x.stride(0), out.stride(0), eps, **p)
    rmsnorm_triton.launches += 1
    return out


rmsnorm_triton.launches = 0
rmsnorm_triton.compiled = None   # the last compiled kernel launched


def layernorm_triton(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    """x: (R, C) CUDA tensor, bf16 or fp32, unit stride along C; g, b: (C,)."""
    _check_rows("layernorm", x, g, b)
    g, b = g.contiguous(), b.contiguous()
    R, C = x.shape
    out = torch.empty((R, C), dtype=x.dtype, device=x.device)
    if R == 0:
        return out
    triton, _, kern = _kernels()
    p = layernorm_params(C)
    layernorm_triton.compiled = kern[(triton.cdiv(R, p["ROWS"]),)](
        x, g, b, out, R, C, x.stride(0), out.stride(0), eps, **p)
    layernorm_triton.launches += 1
    return out


layernorm_triton.launches = 0
layernorm_triton.compiled = None   # the last compiled kernel launched

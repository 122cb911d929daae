"""RMSNorm and LayerNorm as Triton kernels for Hopper, and their backward
(below the forwards: ``rmsnorm_bwd_triton``; for LayerNorm the CUDA C++
ring kernel ``layernorm_bwd_cuda`` (``csrc/layernorm_bwd.cu``), and
``layernorm_bwd_triton`` for the rows it does not take, both behind the
router ``layernorm_bwd``).

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

import ctypes
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


# ---------------------------------------------------------------------------
# RMSNorm backward
# ---------------------------------------------------------------------------
# No TPU kernel is replaced: the JAX package has no backward kernel, since
# ``jax.grad`` differentiates its jnp model in XLA. A train step on the card
# needs one for every forward kernel it launches, and this is RMSNorm's
# (every norm and qk-norm of the dense decoders).
#
# dx = (g dy - xh mean(g dy xh)) rsqrt(var + eps), xh = x rsqrt(var + eps),
# in fp32 and rounded once to x's dtype; dg = sum over rows of dy xh, in fp32.
#
# Bound on an H100: bytes (x and dy read once, dx written once: 6 bytes an
# element in bf16, a dozen fp32 operations). The column sum over all rows
# needs no atomics: each program of the row pass keeps its share of dg and
# writes it as a partial row of a (programs, C) fp32 scratch, and a second
# launch sums the scratch down its columns in an order fixed by the shape,
# so dg is the same from run to run.
#
# Design, from the two launches timed apart (``chip_smoke.py``): the row
# pass of the design it replaced (``rmsnorm_bwd_replaced_triton``: the
# forward's row blocks, four programs an SM, a cross-warp sum of dg's
# partial each block) ran at ~45% of the bound, and its column sum, one
# program per 128 columns (one program at the qk-norm's C = 128), took
# ~26 us alone. Here the row pass has one program an SM, blocks of twice
# the forward's rows (BWD_ROW_FACTOR), loads the next block before it
# computes the current one (the loads in flight during the arithmetic),
# and accumulates dg elementwise, summing over the block's rows once at the
# end; the column sum runs one program per COLSUM_C columns, 128 partial
# rows a step, and writes every column of dg (no zeroing launch).

BWD_PROGRAMS_PER_SM = 1
BWD_ROW_FACTOR = 2       # rows of a block: the forward's ROWS times this
COLSUM_C = 16            # columns of a column-sum program


@functools.cache
def _bwd_kernels():
    """Compile at first use: triton exists only where a card is."""
    global tl
    import triton
    import triton.language as tl

    @triton.jit(do_not_specialize=["R", "rows_per_prog"])
    def rmsnorm_bwd(x_ptr, g_ptr, dy_ptr, dx_ptr, dgp_ptr, R, C, rows_per_prog, stride_x,
                    stride_dy, stride_dx, eps, ROWS: tl.constexpr, BLOCK_C: tl.constexpr):
        pid = tl.program_id(0)
        cols = tl.arange(0, BLOCK_C)
        cmask = cols < C
        g = tl.load(g_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
        acc = tl.zeros((ROWS, BLOCK_C), dtype=tl.float32)
        lo = pid * rows_per_prog
        hi = tl.minimum(lo + rows_per_prog, R)
        rows = lo + tl.arange(0, ROWS)
        mask = (rows[:, None] < hi) & cmask[None, :]
        x_next = tl.load(x_ptr + rows[:, None].to(tl.int64) * stride_x + cols[None, :],
                         mask=mask, other=0.0)
        dy_next = tl.load(dy_ptr + rows[:, None].to(tl.int64) * stride_dy + cols[None, :],
                          mask=mask, other=0.0)
        for start in range(lo, hi, ROWS):
            rows = start + tl.arange(0, ROWS)
            mask = (rows[:, None] < hi) & cmask[None, :]
            x = x_next.to(tl.float32)
            dy = dy_next.to(tl.float32)
            # the next block's loads, in flight while this block computes
            nxt = rows + ROWS
            nmask = (nxt[:, None] < hi) & cmask[None, :]
            x_next = tl.load(x_ptr + nxt[:, None].to(tl.int64) * stride_x + cols[None, :],
                             mask=nmask, other=0.0)
            dy_next = tl.load(dy_ptr + nxt[:, None].to(tl.int64) * stride_dy + cols[None, :],
                              mask=nmask, other=0.0)
            rstd = 1.0 / tl.sqrt(tl.sum(x * x, axis=1) / C + eps)
            xh = x * rstd[:, None]
            w = dy * g[None, :]
            c = tl.sum(w * xh, axis=1) / C
            dx = (w - xh * c[:, None]) * rstd[:, None]
            tl.store(dx_ptr + rows[:, None].to(tl.int64) * stride_dx + cols[None, :],
                     dx.to(dx_ptr.dtype.element_ty), mask=mask)
            acc += dy * xh
        tl.store(dgp_ptr + pid * C + cols, tl.sum(acc, axis=0), mask=cmask)

    @triton.jit(do_not_specialize=["R", "rows_per_prog"])
    def rmsnorm_bwd_replaced(x_ptr, g_ptr, dy_ptr, dx_ptr, dgp_ptr, R, C, rows_per_prog,
                             stride_x, stride_dy, stride_dx, eps, ROWS: tl.constexpr,
                             BLOCK_C: tl.constexpr):
        pid = tl.program_id(0)
        cols = tl.arange(0, BLOCK_C)
        cmask = cols < C
        g = tl.load(g_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
        dg = tl.zeros((BLOCK_C,), dtype=tl.float32)
        lo = pid * rows_per_prog
        hi = tl.minimum(lo + rows_per_prog, R)
        for start in range(lo, hi, ROWS):
            rows = start + tl.arange(0, ROWS)
            mask = (rows[:, None] < hi) & cmask[None, :]
            x = tl.load(x_ptr + rows[:, None].to(tl.int64) * stride_x + cols[None, :],
                        mask=mask, other=0.0).to(tl.float32)
            dy = tl.load(dy_ptr + rows[:, None].to(tl.int64) * stride_dy + cols[None, :],
                         mask=mask, other=0.0).to(tl.float32)
            rstd = 1.0 / tl.sqrt(tl.sum(x * x, axis=1) / C + eps)
            xh = x * rstd[:, None]
            w = dy * g[None, :]
            c = tl.sum(w * xh, axis=1) / C
            dx = (w - xh * c[:, None]) * rstd[:, None]
            tl.store(dx_ptr + rows[:, None].to(tl.int64) * stride_dx + cols[None, :],
                     dx.to(dx_ptr.dtype.element_ty), mask=mask)
            dg += tl.sum(dy * xh, axis=0)
        tl.store(dgp_ptr + pid * C + cols, dg, mask=cmask)

    @triton.jit
    def column_sum(p_ptr, o_ptr, N, C, BLOCK_N: tl.constexpr, BLOCK_C: tl.constexpr):
        cols = tl.program_id(0) * BLOCK_C + tl.arange(0, BLOCK_C)
        acc = tl.zeros((BLOCK_C,), dtype=tl.float32)
        for start in range(0, N, BLOCK_N):
            rows = start + tl.arange(0, BLOCK_N)
            acc += tl.sum(tl.load(p_ptr + rows[:, None] * C + cols[None, :],
                                  mask=(rows[:, None] < N) & (cols[None, :] < C), other=0.0),
                          axis=0)
        tl.store(o_ptr + cols, acc.to(o_ptr.dtype.element_ty), mask=cols < C)

    return triton, rmsnorm_bwd, column_sum, rmsnorm_bwd_replaced


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def bwd_programs(R: int, C: int, sms: int, per_sm: int = BWD_PROGRAMS_PER_SM,
                 row_factor: int = BWD_ROW_FACTOR):
    """(programs, rows a program walks, rows a block) of the row pass at R
    rows of C: at most `per_sm` programs an SM, each a whole number of
    blocks of `row_factor` times the forward's rows."""
    return split_rows(R, launch_params(C)["ROWS"] * row_factor, per_sm * sms)


def split_rows(R: int, rows: int, programs: int):
    """(programs, rows a program walks, `rows`): R rows in blocks of `rows`,
    each program a whole number of blocks, at most `programs` programs."""
    blocks = -(-R // rows)
    per = -(-blocks // min(blocks, programs)) * rows
    return -(-R // per), per, rows


def _check_bwd(x, g, dy):
    _check_rows("rmsnorm_bwd", x, g)
    _check_rows("rmsnorm_bwd", dy, g)
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"rmsnorm_bwd takes dy of x's shape and dtype, got "
                         f"{tuple(dy.shape)} {dy.dtype} for {tuple(x.shape)} {x.dtype}")


def rmsnorm_bwd_launches(x: torch.Tensor, g: torch.Tensor, dy: torch.Tensor,
                         eps: float = 1e-6, replaced: bool = False):
    """(dx, dg, row pass, column sum): the outputs and the two launches that
    fill them, as functions of no argument, not yet run (the wrapper runs
    both; ``chip_smoke.py`` also times them apart). `replaced` gives the
    launches of the design ``rmsnorm_bwd_triton`` replaced."""
    _check_bwd(x, g, dy)
    g = g.contiguous()
    R, C = x.shape
    dx = torch.empty((R, C), dtype=x.dtype, device=x.device)
    dg = torch.empty((C,), dtype=g.dtype, device=g.device)
    triton, kern, colsum, old = _bwd_kernels()
    sms = _sm_count(x.device.index or 0)
    p = launch_params(C)
    if replaced:
        n_prog, per, rows = bwd_programs(R, C, sms, per_sm=4, row_factor=1)
        p_col = {"BLOCK_N": 32, "BLOCK_C": 128, "num_warps": 4}
        kern, p_row = old, p
    else:
        n_prog, per, rows = bwd_programs(R, C, sms)
        p_col = {"BLOCK_N": 128, "BLOCK_C": COLSUM_C, "num_warps": 8}
        p_row = {"ROWS": rows, "BLOCK_C": p["BLOCK_C"], "num_warps": 8}
    partial = torch.empty((n_prog, C), dtype=torch.float32, device=x.device)

    def row_pass():
        return kern[(n_prog,)](x, g, dy, dx, partial, R, C, per, x.stride(0), dy.stride(0),
                               dx.stride(0), eps, **p_row)

    def column_sum():
        if replaced:
            dg.zero_()
        colsum[(triton.cdiv(C, p_col["BLOCK_C"]),)](partial, dg, n_prog, C, **p_col)
    return dx, dg, row_pass, column_sum


def rmsnorm_bwd_triton(x: torch.Tensor, g: torch.Tensor, dy: torch.Tensor,
                       eps: float = 1e-6):
    """(dx, dg) of RMSNorm for the output gradient dy: x, dy (R, C) CUDA
    tensors of one dtype (bf16 or fp32), unit stride along C; g: (C,). dx
    in x's dtype, dg in g's. One launch of the row pass and one of the
    column sum; counts one launch."""
    _check_bwd(x, g, dy)
    if x.shape[0] == 0:
        return torch.empty_like(x), torch.zeros_like(g)
    dx, dg, row_pass, column_sum = rmsnorm_bwd_launches(x, g, dy, eps)
    rmsnorm_bwd_triton.compiled = row_pass()
    column_sum()
    rmsnorm_bwd_triton.launches += 1
    return dx, dg


rmsnorm_bwd_triton.launches = 0
rmsnorm_bwd_triton.compiled = None   # the last compiled row kernel launched


def rmsnorm_bwd_replaced_triton(x: torch.Tensor, g: torch.Tensor, dy: torch.Tensor,
                                eps: float = 1e-6):
    """``rmsnorm_bwd_triton``'s arguments and outputs, on the design it
    replaced (its note), kept to be timed beside it; counts no launch."""
    dx, dg, row_pass, column_sum = rmsnorm_bwd_launches(x, g, dy, eps, replaced=True)
    row_pass()
    column_sum()
    return dx, dg


# ---------------------------------------------------------------------------
# LayerNorm backward
# ---------------------------------------------------------------------------
# No TPU kernel is replaced: ``jax.grad`` differentiates the JAX model's
# LayerNorm in XLA. With xh = (x - mean) rsqrt(var + eps) (the biased
# variance of the centred row, as the forward takes it) and w = g dy, in
# fp32 and rounded once to x's dtype:
#   dx = (w - mean(w) - xh mean(w xh)) rsqrt(var + eps),
#   dg = sum over rows of dy xh,   db = sum over rows of dy   (fp32).
#
# Bound on an H100: bytes (x and dy read once, dx written once: 6 bytes an
# element in bf16, about 15 fp32 operations).
#
# Design: the RMSNorm backward's, with two column sums. The row pass runs
# one program an SM, each walking its share of the rows in blocks, and
# writes dx and the program's fp32 partial rows of dg and db into one
# (programs, 2C) scratch; one column-sum launch sums the scratch down its
# 2C columns in an order fixed by the shape, so dg and db are the same from
# run to run. A row of up to LN_BWD_WHOLE_C columns is held whole in
# registers, the next block loaded while the current one computes, dg and
# db accumulated elementwise and summed over the block's rows once at the
# end. A wider row (gpt3's C = 12288) goes in chunks of LN_BWD_CHUNK_C, as
# the forward goes: a pass for the mean and the centred sum of squares
# (Chan's merge), a pass for mean(w) and mean(w xh), a pass that writes dx;
# the second and third read the rows' blocks again from L1/L2 (a block of
# two such rows is 96 KiB of x and dy), so device memory sees each element
# once each way. The third pass adds the block's share of dg and db to the
# program's partial row in the scratch (98 KiB, held in L2), which only
# that program reads and writes, behind a barrier of its threads. With one
# program an SM and no load issued ahead, what a chunk keeps in flight sets
# the rate: chunks of 2048 columns ran behind ``F.layer_norm``'s backward
# at (4096, 12288), chunks of 4096 (two rows, 8 warps: 32 elements of each
# tensor a thread) caught up with it; of the rows, widths, warps and
# programs an SM tried on the card, these were the fastest, and at C = 2048
# whole rows beat every chunked form. It is the route of the rows the ring
# kernel below does not take (``layernorm_bwd_route``), and is timed beside
# it by ``chip_smoke.py``.

LN_BWD_WHOLE_C = 2048    # a wider row goes in chunks
LN_BWD_CHUNK_C = 4096
LN_BWD_CHUNK_ROWS = 2


@functools.cache
def _ln_bwd_kernels():
    """Compile at first use: triton exists only where a card is."""
    global tl
    import triton
    import triton.language as tl

    @triton.jit(do_not_specialize=["R", "rows_per_prog"])
    def layernorm_bwd(x_ptr, g_ptr, dy_ptr, dx_ptr, part_ptr, R, C, rows_per_prog, stride_x,
                      stride_dy, stride_dx, eps, ROWS: tl.constexpr, BLOCK_C: tl.constexpr):
        pid = tl.program_id(0)
        cols = tl.arange(0, BLOCK_C)
        cmask = cols < C
        g = tl.load(g_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
        acc_g = tl.zeros((ROWS, BLOCK_C), dtype=tl.float32)
        acc_b = tl.zeros((ROWS, BLOCK_C), dtype=tl.float32)
        lo = pid * rows_per_prog
        hi = tl.minimum(lo + rows_per_prog, R)
        rows = lo + tl.arange(0, ROWS)
        mask = (rows[:, None] < hi) & cmask[None, :]
        x_next = tl.load(x_ptr + rows[:, None].to(tl.int64) * stride_x + cols[None, :],
                         mask=mask, other=0.0)
        dy_next = tl.load(dy_ptr + rows[:, None].to(tl.int64) * stride_dy + cols[None, :],
                          mask=mask, other=0.0)
        for start in range(lo, hi, ROWS):
            rows = start + tl.arange(0, ROWS)
            mask = (rows[:, None] < hi) & cmask[None, :]
            x = x_next.to(tl.float32)
            dy = dy_next.to(tl.float32)
            # the next block's loads, in flight while this block computes
            nxt = rows + ROWS
            nmask = (nxt[:, None] < hi) & cmask[None, :]
            x_next = tl.load(x_ptr + nxt[:, None].to(tl.int64) * stride_x + cols[None, :],
                             mask=nmask, other=0.0)
            dy_next = tl.load(dy_ptr + nxt[:, None].to(tl.int64) * stride_dy + cols[None, :],
                              mask=nmask, other=0.0)
            mean = tl.sum(x, axis=1) / C
            xc = tl.where(mask, x - mean[:, None], 0.0)
            rstd = 1.0 / tl.sqrt(tl.sum(xc * xc, axis=1) / C + eps)
            xh = xc * rstd[:, None]
            w = dy * g[None, :]
            c1 = tl.sum(w, axis=1) / C
            c2 = tl.sum(w * xh, axis=1) / C
            dx = (w - c1[:, None] - xh * c2[:, None]) * rstd[:, None]
            tl.store(dx_ptr + rows[:, None].to(tl.int64) * stride_dx + cols[None, :],
                     dx.to(dx_ptr.dtype.element_ty), mask=mask)
            acc_g += dy * xh
            acc_b += dy
        tl.store(part_ptr + pid * 2 * C + cols, tl.sum(acc_g, axis=0), mask=cmask)
        tl.store(part_ptr + pid * 2 * C + C + cols, tl.sum(acc_b, axis=0), mask=cmask)

    @triton.jit(do_not_specialize=["R", "rows_per_prog"])
    def layernorm_bwd_chunked(x_ptr, g_ptr, dy_ptr, dx_ptr, part_ptr, R, C, rows_per_prog,
                              stride_x, stride_dy, stride_dx, eps, ROWS: tl.constexpr,
                              BLOCK_C: tl.constexpr, N_CHUNKS: tl.constexpr):
        pid = tl.program_id(0)
        lo = pid * rows_per_prog
        hi = tl.minimum(lo + rows_per_prog, R)
        part = part_ptr + pid * 2 * C
        for start in range(lo, hi, ROWS):
            rows = start + tl.arange(0, ROWS)
            row_ok = rows[:, None] < hi
            x_rows = x_ptr + rows[:, None].to(tl.int64) * stride_x
            dy_rows = dy_ptr + rows[:, None].to(tl.int64) * stride_dy
            # pass 1: each chunk's mean and centred sum of squares, merged
            mean = tl.zeros((ROWS,), dtype=tl.float32)
            m2 = tl.zeros((ROWS,), dtype=tl.float32)
            for k in range(N_CHUNKS):
                cols = k * BLOCK_C + tl.arange(0, BLOCK_C)
                mask = row_ok & (cols[None, :] < C)
                x = tl.load(x_rows + cols[None, :], mask=mask, other=0.0).to(tl.float32)
                n_k = tl.minimum(C - k * BLOCK_C, BLOCK_C).to(tl.float32)
                mean_k = tl.sum(x, axis=1) / n_k
                xc = tl.where(mask, x - mean_k[:, None], 0.0)
                count = k * BLOCK_C * 1.0               # columns merged so far
                total = count + n_k
                delta = mean_k - mean
                mean = mean + delta * (n_k / total)
                m2 = m2 + tl.sum(xc * xc, axis=1) + delta * delta * (count * n_k / total)
            rstd = 1.0 / tl.sqrt(m2 / C + eps)
            # pass 2: mean(w) and mean(w xh)
            c1 = tl.zeros((ROWS,), dtype=tl.float32)
            c2 = tl.zeros((ROWS,), dtype=tl.float32)
            for k in range(N_CHUNKS):
                cols = k * BLOCK_C + tl.arange(0, BLOCK_C)
                cmask = cols < C
                mask = row_ok & cmask[None, :]
                x = tl.load(x_rows + cols[None, :], mask=mask, other=0.0).to(tl.float32)
                dy = tl.load(dy_rows + cols[None, :], mask=mask, other=0.0).to(tl.float32)
                g = tl.load(g_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
                xh = tl.where(mask, (x - mean[:, None]) * rstd[:, None], 0.0)
                w = dy * g[None, :]
                c1 += tl.sum(w, axis=1)
                c2 += tl.sum(w * xh, axis=1)
            c1 = c1 / C
            c2 = c2 / C
            # pass 3: dx, and the block's share of dg and db added to the
            # program's partial row (zero before its first block); the
            # barrier orders the last block's stores before these loads
            tl.debug_barrier()
            for k in range(N_CHUNKS):
                cols = k * BLOCK_C + tl.arange(0, BLOCK_C)
                cmask = cols < C
                mask = row_ok & cmask[None, :]
                x = tl.load(x_rows + cols[None, :], mask=mask, other=0.0).to(tl.float32)
                dy = tl.load(dy_rows + cols[None, :], mask=mask, other=0.0).to(tl.float32)
                g = tl.load(g_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
                xh = tl.where(mask, (x - mean[:, None]) * rstd[:, None], 0.0)
                w = dy * g[None, :]
                dx = (w - c1[:, None] - xh * c2[:, None]) * rstd[:, None]
                tl.store(dx_ptr + rows[:, None].to(tl.int64) * stride_dx + cols[None, :],
                         dx.to(dx_ptr.dtype.element_ty), mask=mask)
                seen = cmask & (start > lo)
                pg = tl.load(part + cols, mask=seen, other=0.0)
                pb = tl.load(part + C + cols, mask=seen, other=0.0)
                tl.store(part + cols, pg + tl.sum(dy * xh, axis=0), mask=cmask)
                tl.store(part + C + cols, pb + tl.sum(dy, axis=0), mask=cmask)

    return layernorm_bwd, layernorm_bwd_chunked


def layernorm_bwd_params(C: int) -> dict:
    """Rows of a block, block width and chunks of the LayerNorm backward's
    row pass: whole rows of the forward's block up to LN_BWD_WHOLE_C
    columns (N_CHUNKS 1), else LN_BWD_CHUNK_ROWS rows in chunks of
    LN_BWD_CHUNK_C."""
    if C <= LN_BWD_WHOLE_C:
        p = launch_params(C)
        return {"ROWS": p["ROWS"], "BLOCK_C": p["BLOCK_C"], "N_CHUNKS": 1}
    return {"ROWS": LN_BWD_CHUNK_ROWS, "BLOCK_C": LN_BWD_CHUNK_C,
            "N_CHUNKS": -(-C // LN_BWD_CHUNK_C)}


def _check_ln_bwd(x, g, dy):
    _check_rows("layernorm_bwd", x, g)
    _check_rows("layernorm_bwd", dy, g)
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"layernorm_bwd takes dy of x's shape and dtype, got "
                         f"{tuple(dy.shape)} {dy.dtype} for {tuple(x.shape)} {x.dtype}")


def layernorm_bwd_triton(x: torch.Tensor, g: torch.Tensor, dy: torch.Tensor,
                         eps: float = 1e-5):
    """(dx, dg, db) of LayerNorm for the output gradient dy: x, dy (R, C)
    CUDA tensors of one dtype (bf16 or fp32), unit stride along C; g: (C,).
    dx in x's dtype, dg and db in g's. One launch of the row pass and one of
    the column sum; counts one launch."""
    _check_ln_bwd(x, g, dy)
    return _triton_backward(x, g, dy, eps)


def _triton_backward(x, g, dy, eps):
    if x.shape[0] == 0:
        return torch.empty_like(x), torch.zeros_like(g), torch.zeros_like(g)
    g = g.contiguous()
    R, C = x.shape
    dx = torch.empty((R, C), dtype=x.dtype, device=x.device)
    dgb = torch.empty((2 * C,), dtype=g.dtype, device=g.device)
    whole, chunked = _ln_bwd_kernels()
    triton, _, colsum, _ = _bwd_kernels()
    p = layernorm_bwd_params(C)
    n_chunks = p.pop("N_CHUNKS")
    n_prog, per, rows = split_rows(R, p["ROWS"],
                                   BWD_PROGRAMS_PER_SM * _sm_count(x.device.index or 0))
    partial = torch.empty((n_prog, 2 * C), dtype=torch.float32, device=x.device)
    args = (x, g, dy, dx, partial, R, C, per, x.stride(0), dy.stride(0), dx.stride(0), eps)
    if n_chunks > 1:
        layernorm_bwd_triton.compiled = chunked[(n_prog,)](
            *args, ROWS=rows, BLOCK_C=p["BLOCK_C"], N_CHUNKS=n_chunks, num_warps=8)
    else:
        layernorm_bwd_triton.compiled = whole[(n_prog,)](*args, ROWS=rows,
                                                         BLOCK_C=p["BLOCK_C"], num_warps=8)
    colsum[(triton.cdiv(2 * C, COLSUM_C),)](partial, dgb, n_prog, 2 * C, BLOCK_N=128,
                                            BLOCK_C=COLSUM_C, num_warps=8)
    layernorm_bwd_triton.launches += 1
    return dx, dgb[:C], dgb[C:]


layernorm_bwd_triton.launches = 0
layernorm_bwd_triton.compiled = None   # the last compiled row kernel launched


# ---------------------------------------------------------------------------
# LayerNorm backward on a ring of rows (CUDA C++)
# ---------------------------------------------------------------------------
# ``csrc/layernorm_bwd.cu`` (its note gives the design): persistent blocks,
# one an SM, each walking a contiguous range of rows through a ring of
# stages in shared memory filled by bulk copies; dx from registers; dg and
# db as one fp32 partial row a block, summed down the columns in the same
# cooperative launch after a grid barrier, each block its stripe. It takes
# rows whose base, pitch and width are multiples of 16 bytes and widths
# ``ring_shape`` plans. ``layernorm_bwd`` sends any other shape to
# ``layernorm_bwd_triton``, and so bf16 rows of one chunk of the Triton
# design's chunked kernel (LN_BWD_WHOLE_C < C <= LN_BWD_CHUNK_C): at
# rwkv6-7b's 4096 that kernel, its row pair loaded in one go, ran in 0.88x
# the ring's time on an H100 (``chip_smoke.py``, ``[timing] layernorm_bwd
# steps``), while at 384, 2048 and 12288 the ring was as fast or faster.

SMEM_MAX = 232448          # shared memory a block can use on an H100 (227 KB)
RING_FIXED_BYTES = 656     # the kernel's mbarriers and group-sum slots
RING_CONSUMERS = 512       # consumer threads a block
RING_VPT_MAX = {2: 3, 4: 4}   # 16-byte vectors a thread a row, by element size
RING_BYTES = 96 * 1024     # what the ring holds, about
RING_MIN_STAGES, RING_MAX_STAGES = 3, 8   # stages of `groups` rows in the ring


@functools.cache
def ring_shape(C: int, elem_bytes: int):
    """A block's shape for rows of C elements of `elem_bytes` bytes, or None
    where the ring kernel does not take them: ``vpt`` 16-byte vectors a
    thread and ``tg`` threads a row (a multiple of 32; the fewest vectors
    left idle, then the most vectors a thread), ``groups`` rows at a time,
    ``threads`` (the groups' and the producer warp's), ``stages`` of
    ``groups`` rows of x and dy, and ``smem`` bytes (mbarriers and sums, g
    in fp32, and the ring, which also holds the groups' sums at the end and
    the column sum's slices)."""
    row = C * elem_bytes
    if C <= 0 or row % 16 or elem_bytes not in RING_VPT_MAX:
        return None
    cvec = row // 16
    best = None
    for vpt in range(RING_VPT_MAX[elem_bytes], 0, -1):
        tg = 32 * -(-cvec // (32 * vpt))
        if tg <= RING_CONSUMERS and (best is None or tg * vpt - cvec < best[2]):
            best = (vpt, tg, tg * vpt - cvec)
    if best is None:
        return None
    vpt, tg, _ = best
    groups = RING_CONSUMERS // tg
    threads = groups * tg + 32
    stage = groups * 2 * row
    room = (SMEM_MAX - RING_FIXED_BYTES - 4 * C) // stage
    stages = min(max(RING_MIN_STAGES, -(-RING_BYTES // stage)), RING_MAX_STAGES, room)
    slices = min(64, threads // 32)
    ring = max(stages * stage, groups * 8 * C, (slices + -(-slices // 8)) * 32 * 16)
    smem = RING_FIXED_BYTES + 4 * C + ring
    if stages < 2 or smem > SMEM_MAX:
        return None
    return {"vpt": vpt, "tg": tg, "groups": groups, "threads": threads, "stages": stages,
            "smem": smem}


def ring_rows(R: int, blocks: int):
    """Block b's rows [b R // blocks, (b + 1) R // blocks), as the kernel
    takes them."""
    return [(b * R // blocks, (b + 1) * R // blocks) for b in range(blocks)]


@functools.lru_cache(maxsize=64)
def ring_plan(R: int, C: int, elem_bytes: int, sms: int):
    """``ring_shape`` with the launch at R rows on a card of `sms` SMs:
    ``blocks`` (one an SM, at most one a row), each block's ``rows`` and
    the ``partial`` scratch, one fp32 row of dg and db a block; None where
    the ring kernel does not take the rows."""
    plan = ring_shape(C, elem_bytes)
    if plan is None or R <= 0:
        return None
    blocks = min(R, sms)
    return {**plan, "blocks": blocks, "rows": ring_rows(R, blocks), "partial": (blocks, 2 * C)}


def ring_preferred(C: int, dtype: torch.dtype) -> bool:
    """Whether ``layernorm_bwd`` runs 16-byte aligned rows of C elements of
    `dtype` on the ring kernel: where ``ring_shape`` plans them, except bf16
    rows of one chunk of the Triton design (LN_BWD_WHOLE_C < C <=
    LN_BWD_CHUNK_C), which ran faster there."""
    if dtype == torch.bfloat16 and LN_BWD_WHOLE_C < C <= LN_BWD_CHUNK_C:
        return False
    return ring_shape(C, torch.empty((), dtype=dtype).element_size()) is not None


def _ring_aligned(x: torch.Tensor, dy: torch.Tensor) -> bool:
    esz = x.element_size()
    return all(t.data_ptr() % 16 == 0 and (t.stride(0) * esz) % 16 == 0 for t in (x, dy))


def layernorm_bwd_route(x: torch.Tensor, dy: torch.Tensor) -> str:
    """The kernel ``layernorm_bwd`` runs x and dy on: ``"layernorm_bwd"``
    (the ring, ``csrc/layernorm_bwd.cu``) where the bases and row pitches of
    x and dy are multiples of 16 bytes and ``ring_preferred`` holds for the
    width, else ``"layernorm_bwd_triton"``."""
    if _ring_aligned(x, dy) and ring_preferred(x.shape[1], x.dtype):
        return "layernorm_bwd"
    return "layernorm_bwd_triton"


@functools.cache
def _ring_lib():
    from .. import _build
    lib = _build.load("layernorm_bwd")
    lib.layernorm_bwd_ring.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong] * 2
                                       + [ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_void_p])
    lib.layernorm_bwd_ring.restype = ctypes.c_int
    return lib


_COUNTERS: dict = {}


def _counter(device: torch.device, stream: int) -> torch.Tensor:
    """The grid barrier's two counters on this device and stream, zeroed
    once; every launch leaves them at 0."""
    key = (device.index, stream)
    if key not in _COUNTERS:
        _COUNTERS[key] = torch.zeros(2, dtype=torch.int32, device=device)
    return _COUNTERS[key]


def _ring_plan_of(x: torch.Tensor, dy: torch.Tensor):
    """``ring_plan`` for x and dy on x's card, or None where the ring kernel
    does not take them (bases or row pitches off 16 bytes, or no plan)."""
    if not _ring_aligned(x, dy):
        return None
    return ring_plan(x.shape[0], x.shape[1], x.element_size(), _sm_count(x.device.index or 0))


def _ring_run(x, g, dy, eps, plan, whole=True):
    """(dx, dg, db) (dg and db in fp32) from one launch of the ring kernel
    at `plan`, on checked inputs; with ``whole=False`` the row pass alone
    (dx and the partial rows, no dg or db: for timing it apart). Counts no
    launch."""
    R, C = x.shape
    g32 = g.to(torch.float32).contiguous()
    if g32.data_ptr() % 16:
        g32 = g32.clone()
    dx = torch.empty((R, C), dtype=x.dtype, device=x.device)
    dgb = torch.empty((2 * C,), dtype=torch.float32, device=x.device)
    partial = torch.empty(plan["partial"], dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    from .. import _build
    err = _ring_lib().layernorm_bwd_ring(
        x.data_ptr(), dy.data_ptr(), g32.data_ptr(), dx.data_ptr(), partial.data_ptr(),
        dgb.data_ptr(), _counter(x.device, stream).data_ptr(), x.stride(0), dy.stride(0), R, C,
        int(x.dtype == torch.bfloat16), plan["vpt"], plan["tg"], plan["groups"],
        plan["stages"], plan["blocks"], plan["smem"], int(whole), eps, stream)
    _build.check(err, "layernorm_bwd_ring")
    return dx, dgb[:C], dgb[C:]


def layernorm_bwd_ring_row_pass(x: torch.Tensor, g: torch.Tensor, dy: torch.Tensor,
                                eps: float = 1e-5) -> torch.Tensor:
    """dx from the ring kernel's row pass alone, without the grid barrier
    and the column sum (``chip_smoke.py`` times it apart); counts no
    launch."""
    _check_ln_bwd(x, g, dy)
    plan = _ring_plan_of(x, dy)
    if plan is None:
        raise ValueError(f"layernorm_bwd_ring_row_pass: the ring kernel does not take "
                         f"{tuple(x.shape)} {x.dtype} with strides {x.stride()}, {dy.stride()}")
    return _ring_run(x, g, dy, eps, plan, whole=False)[0]


def _ring_backward(x, g, dy, eps, plan):
    dx, dg, db = _ring_run(x, g, dy, eps, plan)
    layernorm_bwd_cuda.launches += 1
    return dx, dg.to(g.dtype), db.to(g.dtype)


def layernorm_bwd_cuda(x: torch.Tensor, g: torch.Tensor, dy: torch.Tensor,
                       eps: float = 1e-5):
    """(dx, dg, db) of LayerNorm on the ring kernel (``csrc/layernorm_bwd.cu``):
    x, dy (R, C) CUDA tensors of one dtype (bf16 or fp32), unit stride
    along C, bases and row pitches multiples of 16 bytes, a width
    ``ring_shape`` plans; g: (C,). dx in x's dtype, dg and db in g's. One
    launch (the column sum inside it); counts one launch. Raises ValueError
    for rows it does not take (``layernorm_bwd`` routes those to
    ``layernorm_bwd_triton``)."""
    _check_ln_bwd(x, g, dy)
    if x.shape[0] == 0:
        return torch.empty_like(x), torch.zeros_like(g), torch.zeros_like(g)
    plan = _ring_plan_of(x, dy)
    if plan is None:
        raise ValueError("layernorm_bwd_cuda takes rows whose base, pitch and width are "
                         f"multiples of 16 bytes and a width ring_shape plans, got "
                         f"{tuple(x.shape)} {x.dtype} with strides {x.stride()} and "
                         f"{dy.stride()}; layernorm_bwd routes the others to "
                         "layernorm_bwd_triton")
    return _ring_backward(x, g, dy, eps, plan)


layernorm_bwd_cuda.launches = 0


def layernorm_bwd(x: torch.Tensor, g: torch.Tensor, dy: torch.Tensor, eps: float = 1e-5):
    """(dx, dg, db) of LayerNorm on the card, on the kernel
    ``layernorm_bwd_route`` names: the ring kernel, or the Triton kernel
    for the rows it does not take or runs slower."""
    _check_ln_bwd(x, g, dy)
    plan = _ring_plan_of(x, dy) if ring_preferred(x.shape[1], x.dtype) else None
    if plan is not None:
        return _ring_backward(x, g, dy, eps, plan)
    return _triton_backward(x, g, dy, eps)

"""Public GEMM ops: the CUDA kernels for a CUDA tensor, the plain versions
for a CPU tensor, after ``repro/kernels/matmul/ops.py``.

``matmul`` (bf16, fp32), ``matmul_int8`` (per-row / per-column symmetric
int8, integer MACs, fused dequantization) and ``matmul_fp8`` (e4m3
cast-through) are the GEMMs the precision model prices at their own widths.
Quantization is plain tensor code outside the kernels on either device; the
quantized B is written column-major ((N,K) in memory, nn.Linear's weight
layout), the layout the 8-bit kernels read. Outputs are in a's dtype.

``bm, bk, bn`` keep the JAX op's names and defaults, and as in JAX each is
first clamped to the GEMM's own extent (``min(bm, M)``, ...). On the card
they then choose the kernel's CTA tile (``kernel.select_tile``: the largest
compiled tile inside the clamped request, else the nearest one); any
positive request runs, and a block that is not positive raises on either
device. Otherwise they change nothing of the function, on the CPU nothing at
all, as the interpret run's blocks change nothing in JAX. ``mapper_blocks``
asks the port's LLMCompass mapper for the tile on the H100 preset.

Shapes choose how a GEMM runs on the card, never whether: int8 takes any K
(exact int32 sums over chunks of at most ``kernel.INT8_MAX_K``, added in
fp32). ``matmul`` takes bf16, fp16 or fp32 operands and ``matmul_fp8``
writes a bf16, fp16 or fp32 output on either device (``matmul_int8``
quantizes any float input).
"""
from __future__ import annotations

import torch

from ...core.hardware import nvidia_h100
from ...core.mapper import matmul_perf
from ...device import runs_plain
from .kernel import TILES, gemm_cuda, int8_gemm_cuda, nearest_tile
from .ref import (dequant_matmul_ref, matmul_fp8_ref, matmul_int8_ref, matmul_ref,
                  quantize_fp8, quantize_int8)


def mapper_blocks(m: int, k: int, n: int) -> tuple:
    """The bf16 kernel's tile for an (m, k, n) GEMM: the mapper's winning
    subtile on ``nvidia_h100()`` mapped onto the nearest compiled tile
    (``kernel.nearest_tile``), as the JAX op maps it onto the TPU's
    128-aligned blocks."""
    mp = matmul_perf(nvidia_h100(), m, k, n).mapping
    return nearest_tile(TILES[torch.bfloat16], (mp.subtile_m, mp.subtile_k, mp.subtile_n))


def _request(a, b, bm, bk, bn) -> tuple:
    """(bm, bk, bn) clamped to the GEMM's extent, as the JAX op clamps its
    blocks; a block that is not positive raises."""
    if min(bm, bk, bn) <= 0:
        raise ValueError(f"GEMM blocks must be positive, got (bm, bk, bn) = ({bm}, {bk}, {bn})")
    (m, k), n = a.shape, b.shape[-1]
    return tuple(max(1, min(x, d)) for x, d in ((bm, m), (bk, k), (bn, n)))


def matmul(a: torch.Tensor, b: torch.Tensor, *, bm: int = 256, bk: int = 512,
           bn: int = 256) -> torch.Tensor:
    """a (M,K) @ b (K,N), bf16, fp16 or fp32, fp32 accumulation, out in a's
    dtype."""
    request = _request(a, b, bm, bk, bn)
    if runs_plain(a):
        return matmul_ref(a, b)
    return gemm_cuda(a.contiguous(), b.contiguous(), request)


def _col_major(q: torch.Tensor) -> torch.Tensor:
    """q (K,N) column-major: its bytes laid out as (N,K)."""
    return q.t().contiguous().t()


def matmul_int8(a: torch.Tensor, b: torch.Tensor, *, bm: int = 256, bk: int = 512,
                bn: int = 256) -> torch.Tensor:
    """Quantized GEMM: A int8-quantized per row and B per column (scale =
    amax/127), integer products, fp32 accumulation, dequantized in the
    epilogue. Approximates ``matmul(a, b)`` to quantization error (~1%) and
    matches ``ref.matmul_int8_ref`` to fp32 association error."""
    request = _request(a, b, bm, bk, bn)
    qa, sa = quantize_int8(a, axis=1)
    qb, sb = quantize_int8(b, axis=0)
    qb = _col_major(qb)
    if runs_plain(a):
        out = dequant_matmul_ref(qa, qb, sa, sb)
    else:
        out = int8_gemm_cuda(qa, qb, sa, sb, request)
    return out.to(a.dtype)


def matmul_fp8(a: torch.Tensor, b: torch.Tensor, *, bm: int = 256, bk: int = 512,
               bn: int = 256) -> torch.Tensor:
    """fp8 GEMM: both operands rounded to e4m3 storage (NaN beyond +-464, as
    the reference casts), multiplied with fp32 accumulation, out in a's
    dtype."""
    request = _request(a, b, bm, bk, bn)
    a8 = quantize_fp8(a)
    b8 = _col_major(quantize_fp8(b))
    if runs_plain(a):
        return matmul_ref(a8, b8, out_dtype=a.dtype)
    return gemm_cuda(a8, b8, request, out_dtype=a.dtype)


reference = matmul_ref
reference_int8 = matmul_int8_ref
reference_fp8 = matmul_fp8_ref

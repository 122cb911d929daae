"""Public GEMM ops: the CUDA kernels for a CUDA tensor, the plain versions
for a CPU tensor, after ``repro/kernels/matmul/ops.py``.

``matmul`` (bf16, fp32), ``matmul_int8`` (per-row / per-column symmetric
int8, integer MACs, fused dequantization) and ``matmul_fp8`` (e4m3
cast-through) are the GEMMs the precision model prices at their own widths.
Quantization is plain tensor code outside the kernels on either device; the
quantized B is written column-major ((N,K) in memory, nn.Linear's weight
layout), the layout the 8-bit kernels read. Outputs are in a's dtype.

``bm, bk, bn`` keep the JAX op's names and defaults. On the card they choose
the kernel's CTA tile: a request is mapped to the largest compiled tile that
fits inside it (``kernel.select_tile``; the JAX default 256/512/256 becomes
128/32/128 for bf16), and one that no compiled tile fits inside raises,
listing the set, on either device. Otherwise they change nothing of the
function, on the CPU nothing at all, as the interpret run's blocks change
nothing in JAX. ``mapper_blocks`` asks the port's LLMCompass mapper for the
tile on the H100 preset.
"""
from __future__ import annotations

import math

import torch

from ...core.hardware import nvidia_h100
from ...core.mapper import matmul_perf
from ...device import runs_plain
from .kernel import TILES, matmul_cuda, matmul_int8_cuda, select_tile
from .ref import (dequant_matmul_ref, matmul_fp8_ref, matmul_int8_ref, matmul_ref,
                  quantize_fp8, quantize_int8)


def mapper_blocks(m: int, k: int, n: int) -> tuple:
    """The bf16 kernel's tile for an (m, k, n) GEMM: the mapper's winning
    subtile on ``nvidia_h100()`` mapped onto the nearest compiled tile
    (least sum of |log2| distances over bm, bk, bn; ties to the larger
    tile), as the JAX op maps it onto the TPU's 128-aligned blocks."""
    mp = matmul_perf(nvidia_h100(), m, k, n).mapping
    want = (mp.subtile_m, mp.subtile_k, mp.subtile_n)

    def distance(t):
        return (sum(abs(math.log2(x / w)) for x, w in zip(t, want)), -t[0] * t[2], -t[1])

    return min(TILES[torch.bfloat16], key=distance)


def matmul(a: torch.Tensor, b: torch.Tensor, *, bm: int = 256, bk: int = 512,
           bn: int = 256) -> torch.Tensor:
    """a (M,K) @ b (K,N), bf16 or fp32, fp32 accumulation, out in a's dtype."""
    tile = select_tile(a.dtype, bm, bk, bn)
    if runs_plain(a):
        return matmul_ref(a, b)
    bm, bk, bn = tile
    return matmul_cuda(a.contiguous(), b.contiguous(), bm=bm, bk=bk, bn=bn)


def _col_major(q: torch.Tensor) -> torch.Tensor:
    """q (K,N) column-major: its bytes laid out as (N,K)."""
    return q.t().contiguous().t()


def matmul_int8(a: torch.Tensor, b: torch.Tensor, *, bm: int = 256, bk: int = 512,
                bn: int = 256) -> torch.Tensor:
    """Quantized GEMM: A int8-quantized per row and B per column (scale =
    amax/127), integer products, fp32 accumulation, dequantized in the
    epilogue. Approximates ``matmul(a, b)`` to quantization error (~1%) and
    matches ``ref.matmul_int8_ref`` to fp32 association error."""
    tile = select_tile(torch.int8, bm, bk, bn)
    qa, sa = quantize_int8(a, axis=1)
    qb, sb = quantize_int8(b, axis=0)
    qb = _col_major(qb)
    if runs_plain(a):
        out = dequant_matmul_ref(qa, qb, sa, sb)
    else:
        bm, bk, bn = tile
        out = matmul_int8_cuda(qa, qb, sa, sb, bm=bm, bk=bk, bn=bn)
    return out.to(a.dtype)


def matmul_fp8(a: torch.Tensor, b: torch.Tensor, *, bm: int = 256, bk: int = 512,
               bn: int = 256) -> torch.Tensor:
    """fp8 GEMM: both operands rounded to e4m3 storage (NaN beyond +-464, as
    the reference casts), multiplied with fp32 accumulation, out in a's
    dtype."""
    tile = select_tile(torch.float8_e4m3fn, bm, bk, bn)
    a8 = quantize_fp8(a)
    b8 = _col_major(quantize_fp8(b))
    if runs_plain(a):
        return matmul_ref(a8, b8, out_dtype=a.dtype)
    bm, bk, bn = tile
    return matmul_cuda(a8, b8, bm=bm, bk=bk, bn=bn, out_dtype=a.dtype)


reference = matmul_ref
reference_int8 = matmul_int8_ref
reference_fp8 = matmul_fp8_ref

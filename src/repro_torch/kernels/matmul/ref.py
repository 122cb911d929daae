"""Plain PyTorch versions of the GEMM kernels and of the quantization around
them, after ``repro/kernels/matmul/ref.py``: an fp32-accumulating matmul,
symmetric int8 quantize/dequantize and the e4m3 cast-through.

``quantize_int8`` and ``quantize_fp8`` are the ops' own quantization on
either device (plain tensor code outside the kernels, as it is outside the
Pallas kernels); both agree bit for bit with the JAX package's.
"""
from __future__ import annotations

import torch

#: beyond this magnitude ml_dtypes' round-to-nearest e4m3 cast gives NaN
#: (464 is the midpoint between 448, the largest e4m3 value, and 480, which
#: would be the next; ties go to 448, the even mantissa)
E4M3_NAN_ABOVE = 464.0


def matmul_ref(a: torch.Tensor, b: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """a (M,K) @ b (K,N): exact products of the operands' values summed in
    fp32 (no TF32 on the card: the callers turn it off), then rounded once
    to ``out_dtype`` (a's dtype by default)."""
    out_dtype = out_dtype or a.dtype
    return torch.matmul(a.float(), b.float()).to(out_dtype)


def matmul_reduce_ref(p: torch.Tensor, out_dtype=torch.float32, a_scale=None,
                      b_scale=None) -> torch.Tensor:
    """The split-K reduction's function: fp32 partials p (S,M,N) added in
    split order, p[0] + p[1] + ..., with scales (a_scale (M,1), b_scale
    (1,N), the int8 GEMM's) multiplied by a_scale and then by b_scale, then
    rounded once to ``out_dtype``."""
    out = torch.zeros(p.shape[1:], dtype=torch.float32, device=p.device)
    for part in p:
        out += part
    if a_scale is not None:
        out = out * a_scale * b_scale
    return out.to(out_dtype)


def quantize_int8(x: torch.Tensor, axis: int):
    """Symmetric per-vector int8 quantization along `axis` (the reduction
    axis of the GEMM): scale = max(amax, 1e-30) / 127 in fp32, q =
    clip(round_half_even(x / scale), -127, 127). Returns (q int8, scale fp32
    shaped to broadcast against x)."""
    xf = x.float()
    amax = xf.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp_min(amax, 1e-30) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def dequant_matmul_ref(qa: torch.Tensor, qb: torch.Tensor, a_scale: torch.Tensor,
                       b_scale: torch.Tensor, out_dtype=torch.float32) -> torch.Tensor:
    """The int8 kernel's function, plainly: qa (M,K), qb (K,N) int8 with
    a_scale (M,1), b_scale (1,N), dequantized and multiplied in fp32."""
    return torch.matmul(dequantize_int8(qa, a_scale),
                        dequantize_int8(qb, b_scale)).to(out_dtype)


def matmul_int8_ref(a: torch.Tensor, b: torch.Tensor, out_dtype=torch.float32) -> torch.Tensor:
    """Quantize-dequantize oracle: per-row (A) / per-column (B) symmetric
    int8 quantization, fp32 GEMM of the dequantized values."""
    qa, sa = quantize_int8(a, axis=1)
    qb, sb = quantize_int8(b, axis=0)
    return dequant_matmul_ref(qa, qb, sa, sb, out_dtype)


def quantize_fp8(x: torch.Tensor) -> torch.Tensor:
    """Round to e4m3 (``torch.float8_e4m3fn``) as the JAX package's
    ``x.astype(jnp.float8_e4m3fn)`` does: NaN wherever |x| > 464, x is
    +-inf or NaN, the nearest e4m3 value (ties to even) elsewhere. Torch's
    own cast saturates to +-448 instead (ROADMAP C1)."""
    xf = x.float()
    xf = torch.where(xf.abs() <= E4M3_NAN_ABOVE, xf, torch.full_like(xf, float("nan")))
    return xf.to(torch.float8_e4m3fn)


def matmul_fp8_ref(a: torch.Tensor, b: torch.Tensor, out_dtype=torch.float32) -> torch.Tensor:
    """fp8 quantize-dequantize oracle: fp32 GEMM of the e4m3-rounded values."""
    return matmul_ref(quantize_fp8(a), quantize_fp8(b), out_dtype)

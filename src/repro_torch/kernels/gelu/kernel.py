"""tanh-GELU and the gated-GELU product ``gelu(g) * u`` as a CUDA C++ kernel
and the SwiGLU gate ``silu(g) * u`` as a Triton kernel, for Hopper.

Replace ``repro/kernels/gelu/kernel.py::gelu_pallas`` and
``::silu_mul_pallas``, elementwise, computed in fp32 and rounded once to the
input dtype:

  * GELU ``0.5 x (1 + tanh(sqrt(2/pi) (x + 0.044715 x^3)))``, evaluated as
    ``x * sigmoid(2 z)`` with ``z = sqrt(2/pi) (x + 0.044715 x^3)``: the
    same function, since ``0.5 (1 + tanh z) = sigmoid(2 z)``. It does not
    cancel where tanh z nears -1 (x below about -3): there ``1 + tanh z``
    keeps only the few bits by which fp32's tanh z differs from -1. It
    saturates cleanly: for |x| of 20, sigmoid(2 z) is exactly 0 or 1 in
    fp32. ``gelu_cuda`` (``csrc/gelu.cu``, whose note gives its design) is
    the kernel; ``gelu_triton``, the Triton kernel it replaced, stays only
    to be timed beside it.
  * gated GELU ``gelu(g) * u`` (``gelu_mul_cuda``, the gated mode of
    ``csrc/gelu.cu``): recurrentgemma's MLP, which the JAX model computes
    with ``jax.nn.gelu`` outside any Pallas kernel
    (``repro/models/layers.py::mlp_apply``).
  * SwiGLU ``g * sigmoid(g) * u`` (``silu_mul_triton``).

Bound on an H100: bytes. GELU reads and writes each element once with about
10 fp32 operations; the gate reads two and writes one with a few.

The Triton kernels: a flat pass over the contiguous elements, BLOCK elements
per program with masked loads at the ragged end; every input is read once
and the result written once, nothing intermediate reaches device memory.
The element count ``n`` is left to Triton's specialisation, which notes that
it is a multiple of 16 (as every model shape is): only then is the mask
``offs < n`` known to be constant over 16 neighbours, so that the masked
loads and stores can go 16 bytes wide. With ``n`` exempted from it, gelu at
(4096, 49152) bf16 took 0.7133 ms against 0.2705 ms with it, and silu_mul at
(4096, 6144) 0.0952 against 0.0564 ms (``chip_smoke.py`` on an NVIDIA H100
80GB HBM3 at 700 W; the bounds are 0.2404 and 0.0451 ms). Triton reaches
the gate's bound within 80% with nothing to hand-tune; GELU went to CUDA
C++ because what was left to change there (the instruction mix, the cache
hints) is what Triton hides.
"""

import ctypes
import functools
import math

import torch

from .. import _build

BLOCK = 4096
_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)


@functools.cache
def _kernels():
    """Compile at first use: triton exists only where a card is."""
    global tl
    import triton
    import triton.language as tl

    @triton.jit
    def gelu_fwd(x_ptr, o_ptr, n, K: tl.constexpr, BLOCK: tl.constexpr):
        offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
        mask = offs < n
        x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        z = K * (x + 0.044715 * x * x * x)
        y = x * tl.sigmoid(2.0 * z)
        tl.store(o_ptr + offs, y.to(o_ptr.dtype.element_ty), mask=mask)

    @triton.jit
    def silu_mul_fwd(g_ptr, u_ptr, o_ptr, n, BLOCK: tl.constexpr):
        offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
        mask = offs < n
        g = tl.load(g_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        u = tl.load(u_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        y = g * tl.sigmoid(g) * u
        tl.store(o_ptr + offs, y.to(o_ptr.dtype.element_ty), mask=mask)

    return triton, gelu_fwd, silu_mul_fwd


def _check_elementwise(what: str, *ts: torch.Tensor) -> None:
    if any(t.shape != ts[0].shape or t.dtype != ts[0].dtype for t in ts):
        raise ValueError(f"{what} takes tensors of one shape and dtype, got "
                         f"{[(tuple(t.shape), t.dtype) for t in ts]}")
    if any(t.device.type != "cuda" or t.device != ts[0].device for t in ts):
        raise ValueError(f"{what} kernel needs its tensors on one CUDA device")
    if ts[0].dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{what} kernel takes bf16/fp32, got {ts[0].dtype}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{what} kernel takes contiguous tensors")


@functools.cache
def _gelu_entry():
    fn = _build.load("gelu").gelu_fwd
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def gelu_cuda(x: torch.Tensor) -> torch.Tensor:
    """x: contiguous CUDA tensor, bf16 or fp32, any shape. One launch of
    ``csrc/gelu.cu``."""
    _check_elementwise("gelu", x)
    out = torch.empty_like(x)
    n = x.numel()
    if n == 0:
        return out
    err = _gelu_entry()(x.data_ptr(), out.data_ptr(), n, int(x.dtype == torch.bfloat16),
                        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "gelu_fwd")
    gelu_cuda.launches += 1
    return out


gelu_cuda.launches = 0


@functools.cache
def _gelu_mul_entry():
    fn = _build.load("gelu").gelu_mul_fwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def gelu_mul_cuda(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """gelu(g) * u in fp32, one rounding: g, u contiguous CUDA tensors of one
    shape and dtype (bf16 or fp32). One launch of ``csrc/gelu.cu``'s gated
    mode."""
    _check_elementwise("gelu_mul", g, u)
    out = torch.empty_like(g)
    n = g.numel()
    if n == 0:
        return out
    err = _gelu_mul_entry()(g.data_ptr(), u.data_ptr(), out.data_ptr(), n,
                            int(g.dtype == torch.bfloat16),
                            torch.cuda.current_stream(g.device).cuda_stream)
    _build.check(err, "gelu_mul_fwd")
    gelu_mul_cuda.launches += 1
    return out


gelu_mul_cuda.launches = 0


def gelu_triton(x: torch.Tensor) -> torch.Tensor:
    """x: contiguous CUDA tensor, bf16 or fp32, any shape. The Triton kernel
    ``gelu_cuda`` replaced, kept to be timed beside it."""
    _check_elementwise("gelu", x)
    out = torch.empty_like(x)
    n = x.numel()
    if n == 0:
        return out
    triton, kern, _ = _kernels()
    gelu_triton.compiled = kern[(triton.cdiv(n, BLOCK),)](
        x, out, n, K=_SQRT_2_OVER_PI, BLOCK=BLOCK, num_warps=8)
    gelu_triton.launches += 1
    return out


gelu_triton.launches = 0
gelu_triton.compiled = None   # the last compiled kernel launched


def silu_mul_triton(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """g, u: contiguous CUDA tensors of one shape and dtype (bf16 or fp32)."""
    _check_elementwise("silu_mul", g, u)
    out = torch.empty_like(g)
    n = g.numel()
    if n == 0:
        return out
    triton, _, kern = _kernels()
    silu_mul_triton.compiled = kern[(triton.cdiv(n, BLOCK),)](
        g, u, out, n, BLOCK=BLOCK, num_warps=8)
    silu_mul_triton.launches += 1
    return out


silu_mul_triton.launches = 0
silu_mul_triton.compiled = None   # the last compiled kernel launched

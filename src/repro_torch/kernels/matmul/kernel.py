"""Wrappers of the CUDA C++ GEMM kernels: ``csrc/matmul.cu`` (``matmul_cuda``,
bf16, fp32 and e4m3 operands), which replaces
``repro/kernels/matmul/kernel.py::matmul_pallas``, and ``csrc/matmul_int8.cu``
(``matmul_int8_cuda``), which replaces ``::matmul_int8_pallas``.

The source files carry the kernels' design notes and their bounds on an
H100. Each wrapper checks what its kernel takes, allocates the output and
launches on the current stream. ``(bm, bk, bn)`` name the CTA tile the
kernel runs with; it must be one of the compiled tiles in ``TILES`` (``bk``
in elements): a TPU-sized block such as 256/512/256 would not fit the 227 KB
of shared memory a block may use. ``select_tile`` maps a request onto the
set.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build

_TC = ((16, 64, 128), (64, 32, 64), (64, 64, 128), (128, 32, 128))
#: compiled (bm, bk, bn) tiles of each operand dtype, bk in elements
TILES = {
    torch.bfloat16: _TC,
    torch.float8_e4m3fn: _TC,
    torch.float32: ((16, 32, 64), (64, 16, 64), (128, 8, 128)),
    torch.int8: ((16, 128, 128), (64, 64, 64), (64, 128, 128), (128, 64, 128)),
}
_MODES = {torch.bfloat16: 0, torch.float8_e4m3fn: 1, torch.float32: 2}
_OUT = (torch.float32, torch.bfloat16)
#: K * 128^2 < 2^31: the int32 sum of K products of any int8 values is exact
INT8_MAX_K = (2 ** 31 - 1) // 128 ** 2


def select_tile(dtype: torch.dtype, bm: int, bk: int, bn: int) -> tuple:
    """The compiled tile a (bm, bk, bn) request runs with: the request itself
    when it is one, else the largest (by bm * bn, then bk) that fits inside
    it on every axis. A request that no compiled tile fits inside raises,
    listing the set."""
    tiles = TILES[dtype if dtype in TILES else torch.bfloat16]
    inside = [t for t in tiles if t[0] <= bm and t[1] <= bk and t[2] <= bn]
    if not inside:
        raise ValueError(f"no compiled {dtype} GEMM tile fits inside (bm, bk, bn) = "
                         f"({bm}, {bk}, {bn}); the compiled tiles are {list(tiles)}")
    return max(inside, key=lambda t: (t[0] * t[2], t[1]))


@functools.cache
def _entry(name: str):
    lib = _build.load(name)
    if name == "matmul":
        fn = lib.matmul_fwd
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    else:
        fn = lib.matmul_int8_fwd
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_shapes(what, a, b):
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"{what} takes a (M,K) and b (K,N), got {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"{what} kernel needs a and b on one CUDA device")


def _launched(err: int, what: str, tile) -> None:
    if err == -1:
        raise ValueError(f"{what}: tile {tile} is not compiled")
    _build.check(err, what)


def matmul_cuda(a: torch.Tensor, b: torch.Tensor, *, bm: int = 128, bk: int = 32,
                bn: int = 128, out_dtype=None) -> torch.Tensor:
    """C (M,N) = a (M,K) @ b (K,N) with an fp32 accumulator, on one CUDA
    device. a and b of one dtype: bf16 or fp32 with both row-major
    (contiguous), or e4m3 (``torch.float8_e4m3fn``) with a row-major and b
    column-major (``b.t()`` contiguous). Output in ``out_dtype`` (fp32 or
    bf16; a's dtype by default, which e4m3 operands must override)."""
    _check_shapes("matmul", a, b)
    if a.dtype not in _MODES or b.dtype != a.dtype:
        raise ValueError(f"matmul kernel takes bf16, fp32 or e4m3 operands of one dtype, "
                         f"got {a.dtype}, {b.dtype}")
    out_dtype = out_dtype or a.dtype
    if out_dtype not in _OUT:
        raise ValueError(f"matmul kernel writes fp32 or bf16, not {out_dtype}")
    b_ok = b.t().is_contiguous() if a.dtype == torch.float8_e4m3fn else b.is_contiguous()
    if not a.is_contiguous() or not b_ok:
        raise ValueError("matmul kernel takes a row-major a, and b row-major (bf16, fp32) "
                         "or column-major (e4m3)")
    tile = (bm, bk, bn)
    if tile not in TILES[a.dtype]:
        raise ValueError(f"matmul kernel has no {a.dtype} tile {tile}; the compiled "
                         f"tiles are {list(TILES[a.dtype])}")
    (M, K), N = a.shape, b.shape[1]
    c = torch.empty((M, N), dtype=out_dtype, device=a.device)
    if M * N == 0:
        return c
    if K == 0:
        return c.zero_()
    err = _entry("matmul")(a.data_ptr(), b.data_ptr(), c.data_ptr(), _MODES[a.dtype], M, N, K,
                           bm, bk, bn, int(out_dtype == torch.bfloat16),
                           torch.cuda.current_stream(a.device).cuda_stream)
    _launched(err, "matmul_fwd", tile)
    matmul_cuda.launches += 1
    return c


matmul_cuda.launches = 0


def matmul_int8_cuda(a: torch.Tensor, b: torch.Tensor, a_scale: torch.Tensor,
                     b_scale: torch.Tensor, *, bm: int = 128, bk: int = 64,
                     bn: int = 128) -> torch.Tensor:
    """C (M,N) = (a (M,K) @ b (K,N)) * a_scale (M,1) * b_scale (1,N): a int8
    row-major, b int8 column-major (``b.t()`` contiguous), scales fp32, on
    one CUDA device; K at most ``INT8_MAX_K``. Output fp32, as
    ``matmul_int8_pallas`` writes it."""
    _check_shapes("matmul_int8", a, b)
    (M, K), N = a.shape, b.shape[1]
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise ValueError(f"matmul_int8 kernel takes int8 operands, got {a.dtype}, {b.dtype}")
    if a_scale.shape != (M, 1) or b_scale.shape != (1, N) or \
            a_scale.dtype != torch.float32 or b_scale.dtype != torch.float32 or \
            a_scale.device != a.device or b_scale.device != a.device:
        raise ValueError(f"matmul_int8 kernel takes fp32 scales ({M}, 1) and (1, {N}) on "
                         f"{a.device}, got {tuple(a_scale.shape)} {a_scale.dtype}, "
                         f"{tuple(b_scale.shape)} {b_scale.dtype}")
    if not a.is_contiguous() or not b.t().is_contiguous():
        raise ValueError("matmul_int8 kernel takes a row-major a and a column-major b")
    if K > INT8_MAX_K:
        raise ValueError(f"matmul_int8 kernel sums K products in int32: K <= {INT8_MAX_K}, "
                         f"got {K}")
    tile = (bm, bk, bn)
    if tile not in TILES[torch.int8]:
        raise ValueError(f"matmul_int8 kernel has no tile {tile}; the compiled tiles are "
                         f"{list(TILES[torch.int8])}")
    c = torch.empty((M, N), dtype=torch.float32, device=a.device)
    if M * N == 0:
        return c
    if K == 0:
        return c.zero_()
    sa, sb = a_scale.contiguous(), b_scale.contiguous()
    err = _entry("matmul_int8")(a.data_ptr(), b.data_ptr(), sa.data_ptr(), sb.data_ptr(),
                                c.data_ptr(), M, N, K, bm, bk, bn,
                                torch.cuda.current_stream(a.device).cuda_stream)
    _launched(err, "matmul_int8_fwd", tile)
    matmul_int8_cuda.launches += 1
    return c


matmul_int8_cuda.launches = 0

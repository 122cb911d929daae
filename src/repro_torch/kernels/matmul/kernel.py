"""Wrappers of the CUDA C++ GEMM kernels, which replace
``repro/kernels/matmul/kernel.py::matmul_pallas`` and ``::matmul_int8_pallas``:

- ``matmul_wgmma_cuda`` (``csrc/matmul_sm90.cu``): bf16 and e4m3 operands
  that a TMA descriptor can describe (``tma_eligible``), a TMA ring feeding
  wgmma; where the output tiles are too few for the card, K is split
  (``split_plan``) and ``matmul_reduce_cuda`` sums the fp32 partials;
- ``matmul_cuda`` (``csrc/matmul.cu``): fp32 operands (IEEE FMAs), and the
  bf16 and e4m3 operands the TMA cannot describe (mma.sync);
- ``matmul_int8_cuda`` (``csrc/matmul_int8.cu``).

``gemm_cuda`` picks between the first two by ``tma_eligible``, before the
launch. The source files carry the kernels' design notes and their bounds on
an H100. Each wrapper checks what its kernel takes, allocates the output and
launches on the current stream, and counts its own launches. ``(bm, bk,
bn)`` name the CTA tile (``bk`` in elements) and must be one of the
kernel's compiled tiles; ``select_tile`` maps any request onto a set.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from .. import _build

#: compiled (bm, bk, bn) tiles of each operand dtype, bk in elements: the
#: wgmma kernel's for bf16 and e4m3, the SIMT kernel's for fp32
TILES = {
    torch.bfloat16: ((64, 64, 256), (128, 64, 256)),
    torch.float8_e4m3fn: ((64, 128, 128), (128, 128, 128)),
    torch.float32: ((16, 32, 64), (64, 16, 64), (128, 8, 128)),
    torch.int8: ((16, 128, 128), (64, 64, 64), (64, 128, 128), (128, 64, 128)),
}
#: the mma.sync kernel's tiles, for bf16 and e4m3 operands TMA cannot describe
MMA_SYNC_TILES = ((16, 64, 128), (64, 32, 64), (64, 64, 128), (128, 32, 128))
_MODES = {torch.bfloat16: 0, torch.float8_e4m3fn: 1, torch.float32: 2}
_WGMMA = (torch.bfloat16, torch.float8_e4m3fn)
_OUT = (torch.float32, torch.bfloat16)
#: how the wgmma kernel multiplies e4m3 operands: widened to fp16 in shared
#: memory ("widened"), or native e4m3 wgmma with a promotion into fp32
#: registers every 128 ("native/128") or every 32 ("native/32") of K
E4M3_FORMS = {"widened": 0, "native/128": 1, "native/32": 2}
E4M3_FORM = "widened"
#: SMs of an H100: K is split where the output tiles number fewer than twice this
SMS = 132
#: K * 128^2 < 2^31: the int32 sum of K products of any int8 values is exact
INT8_MAX_K = (2 ** 31 - 1) // 128 ** 2


def nearest_tile(tiles, want) -> tuple:
    """The tile nearest to `want` (bm, bk, bn): least sum of |log2| distances
    over the three axes, ties to the larger tile (bm * bn, then bk)."""
    def distance(t):
        return (sum(abs(math.log2(x / w)) for x, w in zip(t, want)), -t[0] * t[2], -t[1])

    return min(tiles, key=distance)


def select_tile(dtype: torch.dtype, bm: int, bk: int, bn: int, tiles=None) -> tuple:
    """The compiled tile a (bm, bk, bn) request runs with (of ``tiles``, by
    default ``TILES[dtype]``): the largest (by bm * bn, then bk) that fits
    inside the request on every axis, else the nearest (``nearest_tile``).
    Any positive request maps to a tile; a block that is not positive
    raises."""
    if min(bm, bk, bn) <= 0:
        raise ValueError(f"GEMM blocks must be positive, got (bm, bk, bn) = ({bm}, {bk}, {bn})")
    tiles = tiles or TILES[dtype if dtype in TILES else torch.bfloat16]
    inside = [t for t in tiles if t[0] <= bm and t[1] <= bk and t[2] <= bn]
    if inside:
        return max(inside, key=lambda t: (t[0] * t[2], t[1]))
    return nearest_tile(tiles, (bm, bk, bn))


def tma_eligible(dtype: torch.dtype, m: int, k: int, n: int, a_ptr: int = 0,
                 b_ptr: int = 0) -> bool:
    """Whether the wgmma kernel takes an (m,k) @ (k,n) GEMM: bf16 (A and B
    row-major) or e4m3 (A row-major, B stored (n,k)) operands whose bases
    (``data_ptr()``) are 16-byte aligned and whose row pitches are multiples
    of 16 bytes, as a TMA descriptor needs."""
    if dtype not in _WGMMA:
        return False
    pitches = (2 * k, 2 * n) if dtype == torch.bfloat16 else (k, k)
    return all(x % 16 == 0 for x in (a_ptr, b_ptr, *pitches))


def split_plan(m: int, n: int, k: int, tile) -> tuple:
    """The K ranges ((k0, k1), ...) the wgmma kernel's splits of an (m,k) @
    (k,n) GEMM cover at `tile`: one range where the output tiles number at
    least 2 ``SMS``; else as many splits as bring the blocks to 2 ``SMS``
    (at most one per k-tile), each a whole number of k-tiles but the last,
    which ends at k."""
    bm, bk, bn = tile
    tiles, kt = math.ceil(m / bm) * math.ceil(n / bn), math.ceil(k / bk)
    if tiles >= 2 * SMS or kt <= 1:
        return ((0, k),)
    per = math.ceil(kt / min(kt, math.ceil(2 * SMS / tiles)))
    return tuple((s * per * bk, min(k, (s + 1) * per * bk)) for s in range(math.ceil(kt / per)))


_ENTRIES = {
    "matmul_fwd": ("matmul", [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p]),
    "matmul_sm90_fwd": ("matmul_sm90",
                        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11 + [ctypes.c_void_p]),
    "matmul_sm90_reduce": ("matmul_sm90", [ctypes.c_void_p] * 2 + [ctypes.c_longlong] +
                           [ctypes.c_int] * 2 + [ctypes.c_void_p]),
    "matmul_int8_fwd": ("matmul_int8",
                        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]),
}


@functools.cache
def _entry(fn_name: str):
    lib_name, argtypes = _ENTRIES[fn_name]
    fn = getattr(_build.load(lib_name), fn_name)
    fn.argtypes = argtypes
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
    if err == -2:
        raise RuntimeError(f"{what}: the CUDA driver refused a TMA descriptor")
    _build.check(err, what)


def _check_operands(what, a, b, out_dtype):
    """Checks common to the two bf16/e4m3/fp32 GEMM kernels; returns the
    output dtype (a's by default)."""
    _check_shapes(what, a, b)
    if a.dtype not in _MODES or b.dtype != a.dtype:
        raise ValueError(f"{what} kernel takes bf16, fp32 or e4m3 operands of one dtype, "
                         f"got {a.dtype}, {b.dtype}")
    out_dtype = out_dtype or a.dtype
    if out_dtype not in _OUT:
        raise ValueError(f"{what} kernel writes fp32 or bf16, not {out_dtype}")
    b_ok = b.t().is_contiguous() if a.dtype == torch.float8_e4m3fn else b.is_contiguous()
    if not a.is_contiguous() or not b_ok:
        raise ValueError(f"{what} kernel takes a row-major a, and b row-major (bf16, fp32) "
                         "or column-major (e4m3)")
    return out_dtype


def matmul_cuda(a: torch.Tensor, b: torch.Tensor, *, bm: int = 128, bk: int = 32,
                bn: int = 128, out_dtype=None) -> torch.Tensor:
    """C (M,N) = a (M,K) @ b (K,N) with an fp32 accumulator on the mma.sync /
    SIMT kernel of ``csrc/matmul.cu``, on one CUDA device. a and b of one
    dtype: bf16 or fp32 with both row-major (contiguous), or e4m3
    (``torch.float8_e4m3fn``) with a row-major and b column-major (``b.t()``
    contiguous). Output in ``out_dtype`` (fp32 or bf16; a's dtype by default,
    which e4m3 operands must override). The tile is one of ``TILES[fp32]``
    for fp32, of ``MMA_SYNC_TILES`` for bf16 and e4m3."""
    out_dtype = _check_operands("matmul", a, b, out_dtype)
    tile, tiles = (bm, bk, bn), TILES[torch.float32] if a.dtype == torch.float32 else \
        MMA_SYNC_TILES
    if tile not in tiles:
        raise ValueError(f"matmul kernel has no {a.dtype} tile {tile}; the compiled "
                         f"tiles are {list(tiles)}")
    (M, K), N = a.shape, b.shape[1]
    c = torch.empty((M, N), dtype=out_dtype, device=a.device)
    if M * N == 0:
        return c
    if K == 0:
        return c.zero_()
    err = _entry("matmul_fwd")(a.data_ptr(), b.data_ptr(), c.data_ptr(), _MODES[a.dtype], M, N,
                               K, bm, bk, bn, int(out_dtype == torch.bfloat16),
                               torch.cuda.current_stream(a.device).cuda_stream)
    _launched(err, "matmul_fwd", tile)
    matmul_cuda.launches += 1
    return c


matmul_cuda.launches = 0


def matmul_wgmma_cuda(a: torch.Tensor, b: torch.Tensor, *, bm: int = 128, bk: int = 64,
                      bn: int = 256, out_dtype=None, e4m3_form: str | None = None
                      ) -> torch.Tensor:
    """C (M,N) = a (M,K) @ b (K,N) with fp32 sums on the TMA + wgmma kernel
    of ``csrc/matmul_sm90.cu``, on one CUDA device: bf16 operands both
    row-major, or e4m3 with b column-major, which ``tma_eligible`` must
    accept (a tensor it refuses raises: ``gemm_cuda`` sends it to
    ``matmul_cuda``); tile one of ``TILES[a.dtype]``; output as
    ``matmul_cuda``'s. e4m3 operands are multiplied in ``e4m3_form``
    (``E4M3_FORM`` by default). Where ``split_plan`` splits K, the fp32
    partials go to a workspace that ``matmul_reduce_cuda`` sums."""
    out_dtype = _check_operands("matmul_wgmma", a, b, out_dtype)
    (M, K), N = a.shape, b.shape[1]
    if not tma_eligible(a.dtype, M, K, N, a.data_ptr(), b.data_ptr()):
        raise ValueError(f"matmul_wgmma kernel takes bf16 or e4m3 operands with 16-byte "
                         f"aligned bases and row pitches, got {a.dtype} ({M},{K})x({K},{N})")
    tile = (bm, bk, bn)
    if tile not in TILES[a.dtype]:
        raise ValueError(f"matmul_wgmma kernel has no {a.dtype} tile {tile}; the compiled "
                         f"tiles are {list(TILES[a.dtype])}")
    form = E4M3_FORMS[e4m3_form or E4M3_FORM]
    c = torch.empty((M, N), dtype=out_dtype, device=a.device)
    if M * N == 0:
        return c
    if K == 0:
        return c.zero_()
    plan = split_plan(M, N, K, tile)
    p = torch.empty((len(plan), M, N), dtype=torch.float32, device=a.device) \
        if len(plan) > 1 else None
    kt_per_split = math.ceil((plan[0][1] - plan[0][0]) / bk)
    err = _entry("matmul_sm90_fwd")(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), None if p is None else p.data_ptr(),
        _MODES[a.dtype], form, M, N, K, bm, bk, bn, kt_per_split, len(plan),
        int(out_dtype == torch.bfloat16), torch.cuda.current_stream(a.device).cuda_stream)
    _launched(err, "matmul_sm90_fwd", tile)
    matmul_wgmma_cuda.launches += 1
    if p is not None:
        matmul_reduce_cuda(p, c)
    return c


matmul_wgmma_cuda.launches = 0


def matmul_reduce_cuda(p: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """c (M,N) = p[0] + p[1] + ... (fp32 partials (S,M,N), summed in that
    order, so a result is the same from run to run), written in c's dtype
    (fp32 or bf16), on one CUDA device."""
    if p.device.type != "cuda" or c.device != p.device:
        raise ValueError("matmul_reduce kernel needs p and c on one CUDA device")
    if p.dim() != 3 or p.dtype != torch.float32 or not p.is_contiguous() or \
            c.shape != p.shape[1:] or c.dtype not in _OUT or not c.is_contiguous():
        raise ValueError(f"matmul_reduce kernel takes fp32 partials (S,M,N) and a contiguous "
                         f"fp32 or bf16 c (M,N), got {tuple(p.shape)} {p.dtype}, "
                         f"{tuple(c.shape)} {c.dtype}")
    err = _entry("matmul_sm90_reduce")(p.data_ptr(), c.data_ptr(), c.numel(), p.shape[0],
                                       int(c.dtype == torch.bfloat16),
                                       torch.cuda.current_stream(p.device).cuda_stream)
    _build.check(err, "matmul_sm90_reduce")
    matmul_reduce_cuda.launches += 1
    return c


matmul_reduce_cuda.launches = 0


def gemm_cuda(a: torch.Tensor, b: torch.Tensor, request, out_dtype=None) -> torch.Tensor:
    """The ops' GEMM on the card: bf16 and e4m3 operands that ``tma_eligible``
    accepts go to ``matmul_wgmma_cuda`` at ``select_tile``'s tile of the
    (bm, bk, bn) `request`; other bf16 and e4m3 operands to ``matmul_cuda``
    at its tile of ``MMA_SYNC_TILES``; fp32 to ``matmul_cuda``."""
    (M, K), N = a.shape, b.shape[1]
    if tma_eligible(a.dtype, M, K, N, a.data_ptr(), b.data_ptr()):
        bm, bk, bn = select_tile(a.dtype, *request)
        return matmul_wgmma_cuda(a, b, bm=bm, bk=bk, bn=bn, out_dtype=out_dtype)
    bm, bk, bn = select_tile(a.dtype, *request,
                             tiles=MMA_SYNC_TILES if a.dtype in _WGMMA else None)
    return matmul_cuda(a, b, bm=bm, bk=bk, bn=bn, out_dtype=out_dtype)


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
    err = _entry("matmul_int8_fwd")(a.data_ptr(), b.data_ptr(), sa.data_ptr(), sb.data_ptr(),
                                    c.data_ptr(), M, N, K, bm, bk, bn,
                                    torch.cuda.current_stream(a.device).cuda_stream)
    _launched(err, "matmul_int8_fwd", tile)
    matmul_int8_cuda.launches += 1
    return c


matmul_int8_cuda.launches = 0

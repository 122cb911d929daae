"""Wrappers of the CUDA C++ GEMM kernels, which replace
``repro/kernels/matmul/kernel.py::matmul_pallas`` and ``::matmul_int8_pallas``:

- ``matmul_wgmma_cuda`` (``csrc/matmul_sm90.cu``): bf16, fp16 and e4m3
  operands that a TMA descriptor can describe (``tma_eligible``), a TMA ring feeding
  wgmma; where the output tiles are too few for the card, K is split
  (``split_plan``) and ``matmul_reduce_cuda`` sums the fp32 partials;
- ``matmul_f32_tma_cuda`` (``csrc/matmul_sm90.cu``, its fp32 mode): fp32
  operands that a TMA descriptor can describe, the same TMA ring feeding
  IEEE FFMAs on the CUDA cores (never TF32), K split as for wgmma;
- ``matmul_cuda`` (``csrc/matmul.cu``): the fp32 operands the TMA cannot
  describe (SIMT FMAs), and the bf16, fp16 and e4m3 ones (mma.sync);
- ``matmul_int8_wgmma_cuda`` (``csrc/matmul_sm90.cu``, its int8 mode): int8
  operands that a TMA descriptor can describe, s8 wgmma on the same TMA
  ring, exact int32 sums, the scales fused into the store; K is split where
  the output tiles are too few for the card and wherever it exceeds
  ``INT8_MAX_K`` (``split_plan``), and ``matmul_reduce_cuda`` sums the fp32
  partials and applies the scales;
- ``matmul_int8_cuda`` (``csrc/matmul_int8.cu``): the int8 operands the TMA
  cannot describe (mma.sync).

Outputs are fp32, bf16 or fp16 (``OUT_KINDS``). ``gemm_cuda`` picks between
the bf16/fp16/e4m3/fp32 paths and ``int8_gemm_cuda``
between the int8 ones by ``tma_eligible``, before the launch. The source
files carry the kernels' design notes and their bounds on an H100. Each
wrapper checks what its kernel takes, allocates the output and launches on
the current stream, and counts its own launches. ``(bm, bk, bn)`` name the
CTA tile (``bk`` in elements) and must be one of the kernel's compiled
tiles; ``select_tile`` maps any request onto a set.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from .. import _build

#: compiled (bm, bk, bn) tiles of each operand dtype, bk in elements: the
#: TMA ring kernel's (wgmma for bf16, e4m3 and int8; FFMAs for fp32)
TILES = {
    torch.bfloat16: ((64, 64, 256), (128, 64, 256)),
    torch.float16: ((64, 64, 256), (128, 64, 256)),
    torch.float8_e4m3fn: ((64, 128, 128), (128, 128, 128)),
    torch.float32: ((8, 32, 128), (256, 32, 128)),
    torch.int8: ((64, 128, 256), (128, 128, 256)),
}
#: the SIMT kernel's tiles, for fp32 operands TMA cannot describe
SIMT_TILES = ((16, 32, 64), (64, 16, 64), (128, 8, 128))
#: the mma.sync kernel's tiles, for bf16, fp16 and e4m3 operands TMA cannot describe
MMA_SYNC_TILES = ((16, 64, 128), (64, 32, 64), (64, 64, 128), (128, 32, 128))
#: the int8 mma.sync kernel's tiles, for int8 operands TMA cannot describe
INT8_MMA_SYNC_TILES = ((16, 128, 128), (64, 64, 64), (64, 128, 128), (128, 64, 128))
_MODES = {torch.bfloat16: 0, torch.float8_e4m3fn: 1, torch.float32: 2, torch.float16: 3}
_TMA = (torch.bfloat16, torch.float16, torch.float8_e4m3fn, torch.int8, torch.float32)
#: the output dtypes, by the kernels' out_kind argument
OUT_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_OUT = tuple(OUT_KINDS)
_ROW_MAJOR_B = (torch.bfloat16, torch.float16, torch.float32)
#: how the wgmma kernel multiplies e4m3 operands: widened to fp16 in shared
#: memory ("widened"), or native e4m3 wgmma with a promotion into fp32
#: registers every 128 ("native/128") or every 32 ("native/32") of K
E4M3_FORMS = {"widened": 0, "native/128": 1, "native/32": 2}
E4M3_FORM = "widened"
#: SMs of an H100: K is split where the output tiles number fewer than twice this
SMS = 132
#: K * 128^2 < 2^31: the int32 sum of K products of any int8 values is
#: exact. The int8 kernels sum at most this much of K in int32 and add such
#: chunks in fp32, in order, as the TPU kernel adds its k-blocks
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
    """Whether the TMA ring kernel takes an (m,k) @ (k,n) GEMM: bf16, fp16 or
    fp32 (A and B row-major) or e4m3 or int8 (A row-major, B stored (n,k))
    operands whose bases (``data_ptr()``) are 16-byte aligned and whose row
    pitches are multiples of 16 bytes, as a TMA descriptor needs."""
    if dtype not in _TMA:
        return False
    es = dtype.itemsize
    pitches = (es * k, es * n) if dtype in _ROW_MAJOR_B else (k, k)
    return all(x % 16 == 0 for x in (a_ptr, b_ptr, *pitches))


def split_plan(m: int, n: int, k: int, tile, max_k: int | None = None) -> tuple:
    """The K ranges ((k0, k1), ...) the wgmma kernel's splits of an (m,k) @
    (k,n) GEMM cover at `tile`: one range where the output tiles number at
    least 2 ``SMS``; else as many splits as bring the blocks to 2 ``SMS``
    (at most one per k-tile), each a whole number of k-tiles but the last,
    which ends at k. With `max_k` (int8: ``INT8_MAX_K``) no range spans
    more than max_k, so K is split there too where it is longer."""
    bm, bk, bn = tile
    tiles, kt = math.ceil(m / bm) * math.ceil(n / bn), math.ceil(k / bk)
    least = math.ceil(kt / (max_k // bk)) if max_k and k > max_k else 1
    if (tiles >= 2 * SMS or kt <= 1) and least == 1:
        return ((0, k),)
    want = min(kt, math.ceil(2 * SMS / tiles)) if tiles < 2 * SMS else 1
    per = math.ceil(kt / max(want, least))
    return tuple((s * per * bk, min(k, (s + 1) * per * bk)) for s in range(math.ceil(kt / per)))


def _split_workspace(M: int, N: int, K: int, tile, device, max_k: int | None = None):
    """The TMA ring kernel's launch of ``split_plan``: (fp32 workspace of the
    splits' partials (S,M,N), or None for one split; k-tiles per split;
    number of splits)."""
    plan = split_plan(M, N, K, tile, max_k)
    p = torch.empty((len(plan), M, N), dtype=torch.float32, device=device) \
        if len(plan) > 1 else None
    return p, math.ceil((plan[0][1] - plan[0][0]) / tile[1]), len(plan)


_ENTRIES = {
    "matmul_fwd": ("matmul", [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p]),
    "matmul_sm90_fwd": ("matmul_sm90",
                        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11 + [ctypes.c_void_p]),
    "matmul_sm90_f32_fwd": ("matmul_sm90",
                            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]),
    "matmul_sm90_s8_fwd": ("matmul_sm90",
                           [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]),
    "matmul_sm90_reduce": ("matmul_sm90", [ctypes.c_void_p] * 2 + [ctypes.c_longlong] +
                           [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2 + [ctypes.c_int] +
                           [ctypes.c_void_p]),
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
    """Checks common to the two bf16/fp16/e4m3/fp32 GEMM kernels; returns the
    output dtype (a's by default)."""
    _check_shapes(what, a, b)
    if a.dtype not in _MODES or b.dtype != a.dtype:
        raise ValueError(f"{what} kernel takes bf16, fp16, fp32 or e4m3 operands of one "
                         f"dtype, got {a.dtype}, {b.dtype}")
    out_dtype = out_dtype or a.dtype
    if out_dtype not in _OUT:
        raise ValueError(f"{what} kernel writes fp32, bf16 or fp16, not {out_dtype}")
    b_ok = b.t().is_contiguous() if a.dtype == torch.float8_e4m3fn else b.is_contiguous()
    if not a.is_contiguous() or not b_ok:
        raise ValueError(f"{what} kernel takes a row-major a, and b row-major (bf16, fp16, "
                         "fp32) or column-major (e4m3)")
    return out_dtype


def matmul_cuda(a: torch.Tensor, b: torch.Tensor, *, bm: int = 128, bk: int = 32,
                bn: int = 128, out_dtype=None) -> torch.Tensor:
    """C (M,N) = a (M,K) @ b (K,N) with an fp32 accumulator on the mma.sync /
    SIMT kernel of ``csrc/matmul.cu``, on one CUDA device. a and b of one
    dtype: bf16, fp16 or fp32 with both row-major (contiguous), or e4m3
    (``torch.float8_e4m3fn``) with a row-major and b column-major (``b.t()``
    contiguous). Output in ``out_dtype`` (fp32, bf16 or fp16; a's dtype by
    default, which e4m3 operands must override). The tile is one of
    ``SIMT_TILES`` for fp32, of ``MMA_SYNC_TILES`` for bf16, fp16 and e4m3."""
    out_dtype = _check_operands("matmul", a, b, out_dtype)
    tile, tiles = (bm, bk, bn), SIMT_TILES if a.dtype == torch.float32 else MMA_SYNC_TILES
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
                               K, bm, bk, bn, OUT_KINDS[out_dtype],
                               torch.cuda.current_stream(a.device).cuda_stream)
    _launched(err, "matmul_fwd", tile)
    matmul_cuda.launches += 1
    return c


matmul_cuda.launches = 0


def matmul_wgmma_cuda(a: torch.Tensor, b: torch.Tensor, *, bm: int = 128, bk: int = 64,
                      bn: int = 256, out_dtype=None, e4m3_form: str | None = None
                      ) -> torch.Tensor:
    """C (M,N) = a (M,K) @ b (K,N) with fp32 sums on the TMA + wgmma kernel
    of ``csrc/matmul_sm90.cu``, on one CUDA device: bf16 or fp16 operands
    both row-major, or e4m3 with b column-major, which ``tma_eligible`` must
    accept (a tensor it refuses raises: ``gemm_cuda`` sends it to
    ``matmul_cuda``); tile one of ``TILES[a.dtype]``; output as
    ``matmul_cuda``'s. e4m3 operands are multiplied in ``e4m3_form``
    (``E4M3_FORM`` by default). Where ``split_plan`` splits K, the fp32
    partials go to a workspace that ``matmul_reduce_cuda`` sums."""
    out_dtype = _check_operands("matmul_wgmma", a, b, out_dtype)
    if a.dtype == torch.float32:
        raise ValueError("matmul_wgmma kernel takes bf16, fp16 or e4m3 operands; fp32 runs "
                         "on matmul_f32_tma")
    (M, K), N = a.shape, b.shape[1]
    if not tma_eligible(a.dtype, M, K, N, a.data_ptr(), b.data_ptr()):
        raise ValueError(f"matmul_wgmma kernel takes bf16, fp16 or e4m3 operands with 16-byte "
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
    p, kt_per_split, splits = _split_workspace(M, N, K, tile, a.device)
    err = _entry("matmul_sm90_fwd")(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), None if p is None else p.data_ptr(),
        _MODES[a.dtype], form, M, N, K, bm, bk, bn, kt_per_split, splits,
        OUT_KINDS[out_dtype], torch.cuda.current_stream(a.device).cuda_stream)
    _launched(err, "matmul_sm90_fwd", tile)
    matmul_wgmma_cuda.launches += 1
    if p is not None:
        matmul_reduce_cuda(p, c)
    return c


matmul_wgmma_cuda.launches = 0


def matmul_f32_tma_cuda(a: torch.Tensor, b: torch.Tensor, *, bm: int = 256, bk: int = 32,
                        bn: int = 128, out_dtype=None) -> torch.Tensor:
    """C (M,N) = a (M,K) @ b (K,N), fp32 operands both row-major, IEEE fp32
    sums (never TF32), on the fp32 mode of ``csrc/matmul_sm90.cu`` (a TMA
    ring feeding FFMAs), on one CUDA device; ``tma_eligible`` must accept the
    operands (a pair it refuses raises: ``gemm_cuda`` sends it to
    ``matmul_cuda``); tile one of ``TILES[fp32]``; output fp32 (default),
    bf16 or fp16. Where ``split_plan`` splits K, the fp32 partials go to a workspace
    that ``matmul_reduce_cuda`` sums in order."""
    _check_shapes("matmul_f32_tma", a, b)
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise ValueError(f"matmul_f32_tma kernel takes fp32 operands, got {a.dtype}, {b.dtype}")
    out_dtype = out_dtype or torch.float32
    if out_dtype not in _OUT:
        raise ValueError(f"matmul_f32_tma kernel writes fp32, bf16 or fp16, not {out_dtype}")
    if not a.is_contiguous() or not b.is_contiguous():
        raise ValueError("matmul_f32_tma kernel takes row-major a and b")
    (M, K), N = a.shape, b.shape[1]
    if not tma_eligible(torch.float32, M, K, N, a.data_ptr(), b.data_ptr()):
        raise ValueError(f"matmul_f32_tma kernel takes operands with 16-byte aligned bases "
                         f"and row pitches, got ({M},{K})x({K},{N})")
    tile = (bm, bk, bn)
    if tile not in TILES[torch.float32]:
        raise ValueError(f"matmul_f32_tma kernel has no tile {tile}; the compiled tiles are "
                         f"{list(TILES[torch.float32])}")
    c = torch.empty((M, N), dtype=out_dtype, device=a.device)
    if M * N == 0:
        return c
    if K == 0:
        return c.zero_()
    p, kt_per_split, splits = _split_workspace(M, N, K, tile, a.device)
    err = _entry("matmul_sm90_f32_fwd")(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), None if p is None else p.data_ptr(), M, N, K,
        bm, bk, bn, kt_per_split, splits, OUT_KINDS[out_dtype],
        torch.cuda.current_stream(a.device).cuda_stream)
    _launched(err, "matmul_sm90_f32_fwd", tile)
    matmul_f32_tma_cuda.launches += 1
    if p is not None:
        matmul_reduce_cuda(p, c)
    return c


matmul_f32_tma_cuda.launches = 0


def matmul_reduce_cuda(p: torch.Tensor, c: torch.Tensor, a_scale: torch.Tensor | None = None,
                       b_scale: torch.Tensor | None = None) -> torch.Tensor:
    """c (M,N) = p[0] + p[1] + ... (fp32 partials (S,M,N), summed in that
    order, so a result is the same from run to run), written in c's dtype
    (fp32, bf16 or fp16), on one CUDA device. With fp32 scales a_scale (M,1) and
    b_scale (1,N) (the int8 GEMM's), the sum is multiplied by a_scale and
    then by b_scale, the int8 kernels' order."""
    if p.device.type != "cuda" or c.device != p.device:
        raise ValueError("matmul_reduce kernel needs p and c on one CUDA device")
    if p.dim() != 3 or p.dtype != torch.float32 or not p.is_contiguous() or \
            c.shape != p.shape[1:] or c.dtype not in _OUT or not c.is_contiguous():
        raise ValueError(f"matmul_reduce kernel takes fp32 partials (S,M,N) and a contiguous "
                         f"fp32, bf16 or fp16 c (M,N), got {tuple(p.shape)} {p.dtype}, "
                         f"{tuple(c.shape)} {c.dtype}")
    M, N = c.shape
    scaled = a_scale is not None or b_scale is not None
    if scaled:
        _check_scales("matmul_reduce", a_scale, b_scale, M, N, p.device)
        a_scale, b_scale = a_scale.contiguous(), b_scale.contiguous()
    err = _entry("matmul_sm90_reduce")(p.data_ptr(), c.data_ptr(), c.numel(), p.shape[0],
                                       OUT_KINDS[c.dtype],
                                       a_scale.data_ptr() if scaled else None,
                                       b_scale.data_ptr() if scaled else None, N,
                                       torch.cuda.current_stream(p.device).cuda_stream)
    _build.check(err, "matmul_sm90_reduce")
    matmul_reduce_cuda.launches += 1
    return c


matmul_reduce_cuda.launches = 0


def gemm_cuda(a: torch.Tensor, b: torch.Tensor, request, out_dtype=None) -> torch.Tensor:
    """The ops' GEMM on the card: operands that ``tma_eligible`` accepts go to
    the TMA ring kernel at ``select_tile``'s tile of the (bm, bk, bn)
    `request`: bf16, fp16 and e4m3 to ``matmul_wgmma_cuda``, fp32 to
    ``matmul_f32_tma_cuda``; other operands to ``matmul_cuda`` at its tile
    of ``MMA_SYNC_TILES`` (bf16, fp16, e4m3) or ``SIMT_TILES`` (fp32)."""
    (M, K), N = a.shape, b.shape[1]
    if tma_eligible(a.dtype, M, K, N, a.data_ptr(), b.data_ptr()):
        bm, bk, bn = select_tile(a.dtype, *request)
        kernel = matmul_f32_tma_cuda if a.dtype == torch.float32 else matmul_wgmma_cuda
        return kernel(a, b, bm=bm, bk=bk, bn=bn, out_dtype=out_dtype)
    bm, bk, bn = select_tile(a.dtype, *request,
                             tiles=SIMT_TILES if a.dtype == torch.float32 else MMA_SYNC_TILES)
    return matmul_cuda(a, b, bm=bm, bk=bk, bn=bn, out_dtype=out_dtype)


def _check_scales(what, a_scale, b_scale, M, N, device):
    if not all(t is not None and t.shape == shape and t.dtype == torch.float32
               and t.device == device for t, shape in ((a_scale, (M, 1)), (b_scale, (1, N)))):
        raise ValueError(f"{what} kernel takes fp32 scales ({M}, 1) and (1, {N}) on {device}")


def _check_int8(what, a, b, a_scale, b_scale, tile, tiles):
    """Checks common to the two int8 GEMM kernels."""
    _check_shapes(what, a, b)
    (M, K), N = a.shape, b.shape[1]
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise ValueError(f"{what} kernel takes int8 operands, got {a.dtype}, {b.dtype}")
    _check_scales(what, a_scale, b_scale, M, N, a.device)
    if not a.is_contiguous() or not b.t().is_contiguous():
        raise ValueError(f"{what} kernel takes a row-major a and a column-major b")
    if tile not in tiles:
        raise ValueError(f"{what} kernel has no tile {tile}; the compiled tiles are "
                         f"{list(tiles)}")


def matmul_int8_wgmma_cuda(a: torch.Tensor, b: torch.Tensor, a_scale: torch.Tensor,
                           b_scale: torch.Tensor, *, bm: int = 128, bk: int = 128,
                           bn: int = 256) -> torch.Tensor:
    """C (M,N) = (a (M,K) @ b (K,N)) * a_scale (M,1) * b_scale (1,N) on the
    int8 mode of the TMA + wgmma kernel of ``csrc/matmul_sm90.cu``: a int8
    row-major, b int8 column-major (``b.t()`` contiguous), which
    ``tma_eligible`` must accept (a pair it refuses raises:
    ``int8_gemm_cuda`` sends it to ``matmul_int8_cuda``); scales fp32; tile
    one of ``TILES[int8]``; any K. Each split of ``split_plan`` (with
    ``INT8_MAX_K``) sums exactly in int32; where there is more than one,
    ``matmul_reduce_cuda`` adds their fp32 sums in order and scales them.
    Output fp32, as ``matmul_int8_pallas`` writes it."""
    tile = (bm, bk, bn)
    _check_int8("matmul_int8_wgmma", a, b, a_scale, b_scale, tile, TILES[torch.int8])
    (M, K), N = a.shape, b.shape[1]
    if not tma_eligible(torch.int8, M, K, N, a.data_ptr(), b.data_ptr()):
        raise ValueError(f"matmul_int8_wgmma kernel takes operands with 16-byte aligned bases "
                         f"and row pitches, got ({M},{K})x({K},{N})")
    c = torch.empty((M, N), dtype=torch.float32, device=a.device)
    if M * N == 0:
        return c
    if K == 0:
        return c.zero_()
    sa, sb = a_scale.contiguous(), b_scale.contiguous()
    p, kt_per_split, splits = _split_workspace(M, N, K, tile, a.device, INT8_MAX_K)
    err = _entry("matmul_sm90_s8_fwd")(
        a.data_ptr(), b.data_ptr(), sa.data_ptr(), sb.data_ptr(), c.data_ptr(),
        None if p is None else p.data_ptr(), M, N, K, bm, bk, bn, kt_per_split, splits,
        torch.cuda.current_stream(a.device).cuda_stream)
    _launched(err, "matmul_sm90_s8_fwd", tile)
    matmul_int8_wgmma_cuda.launches += 1
    if p is not None:
        matmul_reduce_cuda(p, c, sa, sb)
    return c


matmul_int8_wgmma_cuda.launches = 0


def matmul_int8_cuda(a: torch.Tensor, b: torch.Tensor, a_scale: torch.Tensor,
                     b_scale: torch.Tensor, *, bm: int = 128, bk: int = 64,
                     bn: int = 128) -> torch.Tensor:
    """C (M,N) = (a (M,K) @ b (K,N)) * a_scale (M,1) * b_scale (1,N) on the
    mma.sync kernel of ``csrc/matmul_int8.cu``: a int8 row-major, b int8
    column-major (``b.t()`` contiguous), scales fp32, on one CUDA device;
    tile one of ``INT8_MMA_SYNC_TILES``; any K (int32 sums over chunks of at
    most ``INT8_MAX_K``, added in fp32 in order). Output fp32, as
    ``matmul_int8_pallas`` writes it."""
    tile = (bm, bk, bn)
    _check_int8("matmul_int8", a, b, a_scale, b_scale, tile, INT8_MMA_SYNC_TILES)
    (M, K), N = a.shape, b.shape[1]
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


def int8_gemm_cuda(a: torch.Tensor, b: torch.Tensor, a_scale: torch.Tensor,
                   b_scale: torch.Tensor, request) -> torch.Tensor:
    """The int8 op's GEMM on the card: operands that ``tma_eligible`` accepts
    go to ``matmul_int8_wgmma_cuda`` at ``select_tile``'s tile of the
    (bm, bk, bn) `request`, others to ``matmul_int8_cuda`` at its tile of
    ``INT8_MMA_SYNC_TILES``."""
    (M, K), N = a.shape, b.shape[1]
    if tma_eligible(torch.int8, M, K, N, a.data_ptr(), b.data_ptr()):
        bm, bk, bn = select_tile(torch.int8, *request)
        return matmul_int8_wgmma_cuda(a, b, a_scale, b_scale, bm=bm, bk=bk, bn=bn)
    bm, bk, bn = select_tile(torch.int8, *request, tiles=INT8_MMA_SYNC_TILES)
    return matmul_int8_cuda(a, b, a_scale, b_scale, bm=bm, bk=bk, bn=bn)

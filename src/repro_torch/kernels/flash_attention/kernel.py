"""Wrappers of the CUDA C++ flash-attention kernels, which replace
``repro/kernels/flash_attention/kernel.py::flash_attention_pallas``:

- ``flash_attention_wgmma_cuda`` (``csrc/flash_attention_sm90.cu``): bf16 at
  D = 64, 128 or 256 with strides a TMA descriptor can describe
  (``wgmma_eligible``): K and V tiles fed by TMA into a ring of shared-memory
  stages, both products on wgmma. The model's prefill takes this path;
- ``flash_attention_cuda`` (``csrc/flash_attention.cu``): everything else the
  card computes: bf16 on mma.sync (D = 32, or strides or bases TMA cannot
  take) and fp32 on scalar FMAs (its 2e-5 tolerance rules out bf16 MMAs),
  at D = 32, 64, 128 or 256.

``attention_cuda`` picks between the two by ``wgmma_eligible``, before the
launch. A head dim between the kernels' (up to 256) runs at the next one up
(``kernel_head_dim``): q, k and v zero-padded along D, the true D's
``1/sqrt(D)`` passed as the scale, the output sliced back; zeros add nothing
to q.k and give zero output columns, so this is exact. The source files carry
the kernels' design notes and their bounds on an H100. Each wrapper checks
what its kernel takes, allocates the output and launches on the current
stream, and counts its own launches. Both take (B, H, S, D) tensors with any
batch, head and sequence strides, so the model's (B, S, H, D) tensors pass as
transposed views without a copy; the output keeps q's memory layout (a padded
call's is a slice of its padded output). The kernels mask the ragged end of
the key axis themselves, so nothing is padded (the TPU op's ``valid_k`` is the
key length here). A head dim above 256 raises on the card; the op's plain
version computes it on the CPU.

The backward of a train step, dq, dk, dv of causal, windowed or full bf16
attention with or without a logit softcap, GQA summed in the kernel, on the
same strided views, has two kernels (each source's note gives its design):

- ``flash_attention_bwd_wgmma_cuda`` (``csrc/flash_attention_bwd_sm90.cu``):
  calls ``bwd_wgmma_eligible`` accepts (D = 64, 128 or 256), given the row
  log-sum-exp the forward wrote (``flash_attention_wgmma_cuda(...,
  lse=...)``): TMA rings, every product on wgmma, two launches. A train
  step takes this path;
- ``flash_attention_bwd_cuda`` (``csrc/flash_attention_bwd.cu``): the rest
  (strides or bases TMA cannot take, or no log-sum-exp) at D = 64 or 128,
  on mma.sync in three launches, the first of which makes its own row
  statistics. D = 256 there raises (ROADMAP B28: no model path gives it).

``attention_bwd_cuda`` picks between the two by the tensors, before the
launch.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from .. import _build
from ...device import address, on_card, sm_count, traced
from .._trace import attention_pairs, launched

HEAD_DIMS = (32, 64, 128, 256)
#: head dims of the TMA + wgmma kernel
WGMMA_HEAD_DIMS = (64, 128, 256)

_STRIDE_ARGS = [ctypes.c_longlong] * 12
_TAIL_ARGS = [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
_ENTRIES = {
    "flash_attention_fwd": ("flash_attention",
                            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + _STRIDE_ARGS
                            + _TAIL_ARGS),
    "flash_attention_sm90_fwd": ("flash_attention_sm90",
                                 [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + _STRIDE_ARGS
                                 + _TAIL_ARGS),
}


@functools.cache
def _entry(fn_name: str):
    lib_name, argtypes = _ENTRIES[fn_name]
    fn = getattr(_build.load(lib_name), fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _work_counter(device: torch.device, stream: int) -> torch.Tensor:
    """The two work counters of the persistent TMA kernels' launches on
    `stream` (the forward, the backward's dq launch): zero before each
    launch, and reset to zero by the launch itself."""
    return torch.zeros(2, dtype=torch.int32, device=device)


def _check(what: str, q, k, v, dtypes, head_dims) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{what} takes q (B,Hq,Sq,D) and k, v (B,Hkv,Sk,D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    if k.shape[0] != B or k.shape[3] != D or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"q {tuple(q.shape)} does not fit k {tuple(k.shape)}")
    if D not in head_dims:
        raise ValueError(f"{what} kernel takes D in {head_dims}, got {D}")
    if q.dtype not in dtypes or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{what} kernel takes one dtype of {dtypes}, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    if not on_card(q) or k.device != q.device or v.device != q.device:
        raise ValueError(f"{what} kernel needs q, k, v on one CUDA device")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError(f"{what} kernel needs a unit stride along D")


def fwd_ops(q: torch.Tensor, k: torch.Tensor, causal: bool, window: int) -> int:
    """Operations of a forward launch: q.k and p.v, 2 D each a scored
    (query, key) pair of each query head."""
    B, Hq, Sq, D = q.shape
    return 4 * D * B * Hq * attention_pairs(Sq, k.shape[2], causal, window)


def bwd_ops(q: torch.Tensor, k: torch.Tensor, causal: bool, window: int) -> int:
    """Operations of a backward launch: five products of 2 D a scored pair
    (q.k again, dO.v, dS.k, dS.q, P.dO) of each query head."""
    B, Hq, Sq, D = q.shape
    return 10 * D * B * Hq * attention_pairs(Sq, k.shape[2], causal, window)


def _tma_strides(t: torch.Tensor) -> tuple:
    """t's (batch, head, seq) element strides, with the stride of an axis of
    extent 1 (never stepped along) replaced by a valid one."""
    return tuple(s if n > 1 else 8 * max(1, t.numel())
                 for n, s in zip(t.shape[:3], t.stride()[:3]))


def kernel_head_dim(D: int) -> int:
    """The head dim of ``HEAD_DIMS`` a call at D runs at: the least one at
    or above D. Above 256 raises."""
    for k in HEAD_DIMS:
        if D <= k:
            return k
    raise ValueError(f"flash attention kernels take D up to {HEAD_DIMS[-1]}, got {D}")


def _tma_describable(t: torch.Tensor) -> bool:
    return t.stride(3) == 1 and address(t) % 16 == 0 and \
        all(s > 0 and s % 8 == 0 for s in _tma_strides(t))


def wgmma_eligible(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether the TMA + wgmma kernel takes an attention call: q, k, v bf16
    (B, H, S, D) with D in ``WGMMA_HEAD_DIMS``, nonempty, a unit stride
    along D, every base 16-byte aligned and every batch, head and sequence
    stride (of an axis longer than 1) a positive multiple of 8 elements, as
    a TMA descriptor needs. The model's transposed (B, S, H, D) views at the
    served widths qualify."""
    ts = (q, k, v)
    if any(t.dtype != torch.bfloat16 or t.dim() != 4 for t in ts):
        return False
    if q.shape[3] not in WGMMA_HEAD_DIMS or q.numel() == 0 or k.numel() == 0:
        return False
    return all(_tma_describable(t) for t in ts)


def flash_attention_wgmma_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                               causal: bool = True, window: int = 0,
                               softcap: float = 0.0, scale: float | None = None,
                               lse: torch.Tensor | None = None) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D), bf16 on one CUDA device,
    which ``wgmma_eligible`` must accept (a call it refuses raises:
    ``attention_cuda`` sends it to ``flash_attention_cuda``). The logits are
    q.k times `scale` (1/sqrt(D) by default). Returns (B, Hq, Sq, D). Given
    `lse`, an fp32 (B, Hq, Sq) contiguous tensor on q's device, the launch
    also writes each row's log-sum-exp there (the natural log over the
    scaled logits of its live keys, +inf for a row with none), which
    ``flash_attention_bwd_wgmma_cuda`` takes; without it (serving) the kernel
    writes none."""
    _check("flash_attention_wgmma", q, k, v, (torch.bfloat16,), WGMMA_HEAD_DIMS)
    if not wgmma_eligible(q, k, v):
        raise ValueError("flash_attention_wgmma kernel takes nonempty tensors with 16-byte "
                         "aligned bases and strides that are multiples of 8 elements")
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    if lse is not None:
        _check_lse(lse, q)
    o = torch.empty_like(q)
    ops = fwd_ops(q, k, causal, window)
    if traced(q):
        return launched(flash_attention_wgmma_cuda, ops, o)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _entry("flash_attention_sm90_fwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        None if lse is None else lse.data_ptr(), _work_counter(q.device, stream).data_ptr(),
        B, Hq, Hkv, Sq, Sk, D, *_tma_strides(q), *_tma_strides(k), *_tma_strides(v),
        *o.stride()[:3], int(causal), int(window),
        float(softcap), 1.0 / math.sqrt(D) if scale is None else scale, stream)
    if err == -2:
        raise RuntimeError("flash_attention_sm90_fwd: the CUDA driver refused a TMA descriptor")
    _build.check(err, "flash_attention_sm90_fwd")
    launched(flash_attention_wgmma_cuda, ops)
    return o


flash_attention_wgmma_cuda.launches = 0


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: int = 0,
                         softcap: float = 0.0, scale: float | None = None) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D), CUDA, bf16 or fp32, unit
    stride along D; D in ``HEAD_DIMS``; the logits are q.k times `scale`
    (1/sqrt(D) by default). Returns (B, Hq, Sq, D)."""
    _check("flash attention", q, k, v, (torch.bfloat16, torch.float32), HEAD_DIMS)
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    ops = fwd_ops(q, k, causal, window)
    if traced(q):
        return launched(flash_attention_cuda, ops, o)
    err = _entry("flash_attention_fwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), int(q.dtype == torch.bfloat16),
        B, Hq, Hkv, Sq, Sk, D, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *o.stride()[:3], int(causal), int(window), float(softcap),
        1.0 / math.sqrt(D) if scale is None else scale,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention_fwd")
    launched(flash_attention_cuda, ops)
    return o


flash_attention_cuda.launches = 0


def attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, window: int = 0, softcap: float = 0.0,
                   with_lse: bool = False):
    """The op's attention on the card: calls ``wgmma_eligible`` accepts go to
    ``flash_attention_wgmma_cuda``, all others to ``flash_attention_cuda``;
    a head dim between the kernels' runs zero-padded to ``kernel_head_dim``
    at its own scale, the output sliced back. With `with_lse` returns (o,
    lse): the rows' log-sum-exp from the wgmma kernel, or None from the
    other, which writes none."""
    D = q.shape[-1]
    Dk = kernel_head_dim(D)
    if Dk != D:
        q, k, v = (torch.nn.functional.pad(t, (0, Dk - D)) for t in (q, k, v))
    lse = None
    if wgmma_eligible(q, k, v):
        out = {}
        if with_lse:
            out["lse"] = lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
        o = flash_attention_wgmma_cuda(q, k, v, causal=causal, window=window,
                                       softcap=softcap, scale=1.0 / math.sqrt(D), **out)
    else:
        o = flash_attention_cuda(q, k, v, causal=causal, window=window, softcap=softcap,
                                 scale=1.0 / math.sqrt(D))
    o = o if Dk == D else o[..., :D]
    return (o, lse) if with_lse else o


# ---------------------------------------------------------------------------
# backward (csrc/flash_attention_bwd_sm90.cu, csrc/flash_attention_bwd.cu)
# ---------------------------------------------------------------------------

#: head dims of the wgmma backward kernel
BWD_HEAD_DIMS = (64, 128, 256)
#: head dims of the mma.sync backward kernel (D = 256 at strides TMA cannot
#: describe: ROADMAP B28)
BWD_MMA_HEAD_DIMS = (64, 128)
#: the wgmma backward's (L log2 e, delta) scratch holds Sq rounded up to it
BWD_TILE_ROWS = 128


def bwd_key_tile(D: int) -> int:
    """Rows of a work tile of the wgmma backward (keys in its dk/dv launch,
    queries in its dq one): 128, or 64 at D = 256, whose two consumers take
    D's halves of dQ, or of dK and dV, of the same rows and split S and dP
    by columns, handing each other their halves."""
    return 64 if D == 256 else BWD_TILE_ROWS


def bwd_part_floats(D: int) -> int:
    """fp32 partial sums a thread of a split dk/dv work tile writes: its
    share of dK and of dV, D (D / 2 at D = 256, where it keeps half of D)."""
    return D // 2 if D == 256 else D


def _check_lse(lse: torch.Tensor, q: torch.Tensor) -> None:
    if lse.shape != q.shape[:3] or lse.dtype != torch.float32 or lse.device != q.device \
            or not lse.is_contiguous():
        raise ValueError(f"lse must be a contiguous fp32 {tuple(q.shape[:3])} tensor on "
                         f"{q.device}, got {tuple(lse.shape)} {lse.dtype} {lse.device}")


def _check_bwd(what: str, q, k, v, o, do, head_dims) -> None:
    _check(what, q, k, v, (torch.bfloat16,), head_dims)
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device \
                or t.stride(3) != 1:
            raise ValueError(f"{what} takes {name} of q's shape, dtype and "
                             f"device with a unit stride along D, got {tuple(t.shape)} "
                             f"{t.dtype} {t.device} strides {t.stride()}")


def bwd_wgmma_eligible(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                       do: torch.Tensor) -> bool:
    """Whether the TMA + wgmma backward takes a call: what ``wgmma_eligible``
    asks of q, k, v also of o and do, and D in ``BWD_HEAD_DIMS``. The
    model's transposed views at the trained widths qualify."""
    return (q.dim() == 4 and q.shape[3] in BWD_HEAD_DIMS and wgmma_eligible(q, k, v)
            and all(t.dtype == torch.bfloat16 and t.shape == q.shape and _tma_describable(t)
                    for t in (o, do)))


def bwd_head_splits(tiles: int, G: int, sms: int) -> int:
    """The query-head groups a dk/dv work tile (``bwd_key_tile`` keys of
    one batch row and kv-head) of the wgmma backward splits into at D = 64
    and 128, a block each: 1 where the `tiles` fill the `sms`, else as many
    as fit, at most G, each of whole heads and none empty (D = 256 splits
    each tile by its own work: ``bwd_dkdv_plan``)."""
    splits = max(1, min(G, sms // max(tiles, 1)))
    per = -(-G // splits)
    return -(-G // per)


def bwd_pair_group(pairs: int, G: int, Sq: int, D: int) -> int:
    """(batch, kv-head) pairs a group of the dk/dv launch's work tiles: the
    kernel's ``group_of``, their Q and dO within 4 MiB of the L2."""
    return max(1, min(pairs, (4 << 20) // (4 * Sq * D * G)))


def bwd_query_tiles(r0: int, Sq: int, causal: bool, window: int, rows: int = 64) -> int:
    """The 64-row query tiles the dk/dv work tile of keys r0 .. r0 + rows - 1
    walks for each of its heads (the kernel's q_begin and q_end): from the
    diagonal if causal, up to the last query the window lets see its last
    key."""
    q_begin = r0 // 64 * 64 if causal else 0
    q_end = min(Sq, r0 + rows - 1 + window) if window > 0 else Sq
    return max(0, -(-(q_end - q_begin) // 64))


def bwd_tile_work(B: int, Hkv: int, Sq: int, Sk: int, G: int, causal: bool,
                  window: int) -> list:
    """The query tiles each work tile of the D = 256 dk/dv launch (64 keys
    of one batch row and kv-head) walks for each of its heads, the tiles in
    the kernel's order (``tile_of``: groups of ``bwd_pair_group`` pairs,
    within a group the key tiles from the first, the pairs fastest)."""
    KT = 64
    nt = -(-Sk // KT)
    pairs = B * Hkv
    group = bwd_pair_group(pairs, G, Sq, 256)
    key_index = []  # the key tile of each work tile, in order
    for g0 in range(0, pairs, group):
        n = min(pairs - g0, group)
        key_index += [i for i in range(nt) for _ in range(n)]
    return [bwd_query_tiles(i * KT, Sq, causal, window, KT) for i in key_index]


def bwd_dkdv_plan(B: int, Hkv: int, Sq: int, Sk: int, G: int, causal: bool, window: int,
                  sms: int) -> list:
    """The blocks of the D = 256 dk/dv launch, in launch order: (work tile,
    first head, end head, the tile's first block, its blocks), the work
    tiles in the kernel's order (``bwd_tile_work``). Each tile's G heads
    split into groups of whole heads, a block each: the fewest iterations
    (query tiles) a block that keep the blocks within the `sms`, or within
    the tiles where those are more (no split); so a tile that sees more
    queries splits into more blocks. recurrentgemma-2b's 8 x 512 on 1
    kv-head, G = 10: 128 blocks, at most 30 iterations a block, against 40
    under one split for all."""
    work = bwd_tile_work(B, Hkv, Sq, Sk, G, causal, window)
    most = max(max(work), 1)

    def heads_a_block(limit, w):
        return G if w == 0 else max(1, min(G, limit // w))

    def blocks(limit):
        return sum(-(-G // heads_a_block(limit, w)) for w in work)

    budget = max(sms, len(work))
    limit = next(x for x in range(most, G * most + 1) if blocks(x) <= budget)
    plan = []
    for tile, w in enumerate(work):
        per = heads_a_block(limit, w)
        count = -(-G // per)
        first = len(plan)
        plan += [(tile, j * per, min(G, (j + 1) * per), first, count) for j in range(count)]
    return plan


@functools.cache
def _tile_counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """One int a dk/dv work tile for launches on `stream` that split its
    heads: zero before each launch, and reset to zero by the launch."""
    return torch.zeros(n, dtype=torch.int32, device=device)


@functools.cache
def _dkdv_plan(device: torch.device, B: int, Hkv: int, Sq: int, Sk: int, G: int,
               causal: bool, window: int, sms: int):
    """``bwd_dkdv_plan`` as the kernel reads it (five int32 a block, on
    `device`), and its blocks."""
    plan = bwd_dkdv_plan(B, Hkv, Sq, Sk, G, causal, window, sms)
    return torch.tensor(plan, dtype=torch.int32, device=device).flatten(), len(plan)


@functools.cache
def _bwd_sm90_entry():
    fn = _build.load("flash_attention_bwd_sm90").flash_attention_bwd_sm90
    fn.argtypes = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 8 + [ctypes.c_longlong] * 24
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flash_attention_bwd_wgmma_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                   o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor, *,
                                   causal: bool = True, window: int = 0,
                                   softcap: float = 0.0, phases: int = 3):
    """(dq, dk, dv) of attention for the output gradient `do`, as
    ``flash_attention_bwd_cuda``, on ``csrc/flash_attention_bwd_sm90.cu``:
    q, k, v, o, do as ``bwd_wgmma_eligible`` accepts (a call it refuses
    raises: ``attention_bwd_cuda`` sends it to ``flash_attention_bwd_cuda``)
    and `lse` the rows' log-sum-exp that ``flash_attention_wgmma_cuda`` wrote
    in the forward under the same mask and softcap, which is not
    recomputed. Two launches (dq with delta, then dk and dv, a key tile's
    heads split over several blocks where the tiles are few:
    ``bwd_head_splits``, at D = 256 by each tile's work: ``bwd_dkdv_plan``)
    on the current stream, no atomics on the results,
    so the same bits from run to run; counts one launch. `phases` 1 or 2
    runs only the first or only the second launch (to time them apart; the
    second reads what the first wrote in an earlier call on these tensors)
    and counts none."""
    _check_bwd("flash_attention_bwd_wgmma", q, k, v, o, do, BWD_HEAD_DIMS)
    if not bwd_wgmma_eligible(q, k, v, o, do):
        raise ValueError("flash_attention_bwd_wgmma kernel takes nonempty tensors with "
                         "16-byte aligned bases and strides that are multiples of 8 elements")
    _check_lse(lse, q)
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    sq_pad = -(-Sq // BWD_TILE_ROWS) * BWD_TILE_ROWS
    stats = _bwd_stats(q.device, B * Hq * sq_pad) if phases != 3 else \
        torch.empty(B * Hq * sq_pad * 2, dtype=torch.float32, device=q.device)
    tiles = -(-Sk // bwd_key_tile(D)) * B * Hkv
    sms = sm_count(q)
    plan, splits = None, 1
    if D == 256 and traced(q):
        blocks = len(bwd_dkdv_plan(B, Hkv, Sq, Sk, Hq // Hkv, causal, window, sms))
    elif D == 256:
        plan, blocks = _dkdv_plan(q.device, B, Hkv, Sq, Sk, Hq // Hkv, causal, window, sms)
    else:
        splits = bwd_head_splits(tiles, Hq // Hkv, sms)
        blocks = tiles * splits
    part = done = None
    if blocks > tiles:  # a tile in more than one block
        # fp32 dK and dV partials, 256 threads a block
        part = torch.empty(blocks * 256 * bwd_part_floats(D), dtype=torch.float32,
                           device=q.device)
    ops = bwd_ops(q, k, causal, window)
    if traced(q):
        return launched(flash_attention_bwd_wgmma_cuda, ops, (dq, dk, dv))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if part is not None:
        done = _tile_counters(q.device, stream, tiles)
    err = _bwd_sm90_entry()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
        _work_counter(q.device, stream).data_ptr(), None if part is None else part.data_ptr(),
        None if done is None else done.data_ptr(), None if plan is None else plan.data_ptr(),
        blocks, splits, B, Hq, Hkv, Sq, Sk, D,
        *_tma_strides(q), *_tma_strides(k), *_tma_strides(v), *o.stride()[:3],
        *_tma_strides(do), *dq.stride()[:3], *dk.stride()[:3], *dv.stride()[:3],
        int(causal), int(window), float(softcap), 1.0 / math.sqrt(D), phases, stream)
    if err == -2:
        raise RuntimeError("flash_attention_bwd_sm90: the CUDA driver refused a TMA descriptor")
    _build.check(err, "flash_attention_bwd_sm90")
    if phases == 3:
        launched(flash_attention_bwd_wgmma_cuda, ops)
    return dq, dk, dv


flash_attention_bwd_wgmma_cuda.launches = 0


@functools.cache
def _bwd_stats(device: torch.device, rows: int) -> torch.Tensor:
    """The scratch the two launches share when timed apart (``phases`` 1 and
    2): one per size, kept, so that the second finds what the first wrote."""
    return torch.empty(rows * 2, dtype=torch.float32, device=device)


@functools.cache
def _bwd_entry():
    fn = _build.load("flash_attention_bwd").flash_attention_bwd
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 24
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             o: torch.Tensor, do: torch.Tensor, *, causal: bool = True,
                             window: int = 0, softcap: float = 0.0):
    """(dq, dk, dv) of attention for the output gradient `do`: q, o, do
    (B, Hq, Sq, D) and k, v (B, Hkv, Sk, D), bf16 on one CUDA device, D in
    ``BWD_MMA_HEAD_DIMS`` (D = 256 raises ``ValueError``: ROADMAP B28), any
    (batch, head, seq) strides with a unit stride along D; o the forward's
    output; causal, windowed or full, with or without a softcap. dq, dk and
    dv keep q's and k's memory layouts. Three launches of
    ``csrc/flash_attention_bwd.cu`` (row statistics, dk and dv, dq) on the
    current stream; counts one launch."""
    if q.dim() == 4 and q.shape[3] == 256:
        raise ValueError("flash_attention_bwd kernel takes D in (64, 128): D = 256 runs on "
                         "the wgmma backward, at strides TMA can describe (ROADMAP B28)")
    _check_bwd("flash_attention_bwd", q, k, v, o, do, BWD_MMA_HEAD_DIMS)
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    ops = bwd_ops(q, k, causal, window)
    if traced(q):
        return launched(flash_attention_bwd_cuda, ops, (dq, dk, dv))
    err = _bwd_entry()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), lse.data_ptr(), delta.data_ptr(), B, Hq, Hkv, Sq, Sk, D,
        *(s for t in (q, k, v, o, do, dq, dk, dv) for s in t.stride()[:3]), int(causal),
        int(window), float(softcap), 1.0 / math.sqrt(D),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention_bwd")
    launched(flash_attention_bwd_cuda, ops)
    return dq, dk, dv


flash_attention_bwd_cuda.launches = 0


def attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                       do: torch.Tensor, lse: torch.Tensor | None = None, *,
                       causal: bool = True, window: int = 0, softcap: float = 0.0):
    """The op's backward on the card: given the forward's `lse`, calls
    ``bwd_wgmma_eligible`` accepts go to ``flash_attention_bwd_wgmma_cuda``,
    all others to ``flash_attention_bwd_cuda``."""
    if lse is not None and bwd_wgmma_eligible(q, k, v, o, do):
        return flash_attention_bwd_wgmma_cuda(q, k, v, o, do, lse, causal=causal,
                                              window=window, softcap=softcap)
    return flash_attention_bwd_cuda(q, k, v, o, do, causal=causal, window=window,
                                    softcap=softcap)

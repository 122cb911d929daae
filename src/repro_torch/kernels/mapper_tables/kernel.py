"""Wrapper of ``csrc/mapper_tables.cu`` (``mapper_tables_cuda``), the
mapper's candidate tables on the card, which replace the JAX package's
jitted XLA pass ``repro/core/mapper_jax.py::_tables_kernel``.

The source carries the kernel's design notes and its bound on an H100. The
wrapper checks what the kernel takes, allocates its packed output, launches
on the current stream and counts its launches; ``ops.py`` packs a gathered
chunk into the kernel's inputs and unpacks its output into numpy's tables.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from ...device import address, on_card, traced
from .._trace import launched

#: bytes the kernel writes a row: totals (4 float64), tile_time (2), the step
#: and write-back times (1 + 1), steps and the three tile counts (4 int64)
#: and use_s2 (2 bytes)
OUT_BYTES_PER_ROW = 8 * (4 + 2 + 1 + 1) + 8 * 4 + 2
#: bytes the kernel reads a row: six int64 tile sizes and four pipeline flags
IN_BYTES_PER_ROW = 6 * 8 + 4
#: per-pair columns: int64 hardware and shape integers, float64 rates
PAIR_INTS = ("sa_rows", "sa_cols", "lanes", "cores", "gb_bw_cyc", "vec_tp",
             "m", "k", "n", "batch", "b_shared")
PAIR_FLOATS = ("freq", "mem_bw", "mac_scale")
#: the byte-width columns, int64 or float64 each (bit i of the float mask)
WIDTHS = ("bytes_a", "bytes_b", "bytes_out", "bytes_acc")


@functools.cache
def _entry():
    fn = _build.load("mapper_tables").mapper_tables
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def mapper_tables_cuda(cols: torch.Tensor, p_ok: torch.Tensor, offs: torch.Tensor,
                       pint: torch.Tensor, pflt: torch.Tensor, pbytes: torch.Tensor,
                       float_mask: int) -> torch.Tensor:
    """cols: int64 (6, rows), the rows' tm, tk, tn, sm, sk, sn; p_ok: bool or
    uint8 (rows, 4); offs: int64 (pairs + 1,), each pair's first row and
    rows at the end; pint: int64 (pairs, 11) in ``PAIR_INTS`` order; pflt:
    float64 (pairs, 3) in ``PAIR_FLOATS`` order; pbytes: int64 (pairs, 4),
    the ``WIDTHS``, as float64 bits where bit i of ``float_mask`` is set;
    all contiguous on one CUDA device, p_ok at a 4-byte boundary. Returns
    the packed tables, uint8 (rows * OUT_BYTES_PER_ROW,), which
    ``ops.unpack`` reads."""
    rows, pairs = cols.shape[-1], pint.shape[0]
    ts = (cols, p_ok, offs, pint, pflt, pbytes)
    dev = cols.device
    if not on_card(cols) or any(t.device != dev for t in ts):
        raise ValueError("mapper_tables kernel needs its tensors on one CUDA device")
    if cols.dim() != 2 or cols.shape[0] != 6 or rows < 1 or pairs < 1:
        raise ValueError(f"mapper_tables takes cols of (6, rows >= 1) and >= 1 pair, got "
                         f"{tuple(cols.shape)} and {pairs} pairs")
    want = {"cols": (cols, torch.int64, (6, rows)), "offs": (offs, torch.int64, (pairs + 1,)),
            "pint": (pint, torch.int64, (pairs, len(PAIR_INTS))),
            "pflt": (pflt, torch.float64, (pairs, len(PAIR_FLOATS))),
            "pbytes": (pbytes, torch.int64, (pairs, len(WIDTHS)))}
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"mapper_tables takes {name} as {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if p_ok.dtype not in (torch.bool, torch.uint8) or tuple(p_ok.shape) != (rows, 4) \
            or address(p_ok) % 4:
        raise ValueError(f"mapper_tables takes p_ok as bool (rows, 4) at a 4-byte boundary, "
                         f"got {p_ok.dtype} {tuple(p_ok.shape)}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("mapper_tables takes contiguous tensors")
    if not 0 <= float_mask < 16:
        raise ValueError(f"mapper_tables takes a 4-bit float mask, got {float_mask}")
    out = torch.empty(rows * OUT_BYTES_PER_ROW, dtype=torch.uint8, device=dev)
    # its int64 and float64 work has no rate in the card's table: its bound
    # is its bytes, and it counts no operations
    if traced(cols):
        return launched(mapper_tables_cuda, 0, out)
    err = _entry()(cols.data_ptr(), p_ok.data_ptr(), offs.data_ptr(), pint.data_ptr(),
                   pflt.data_ptr(), pbytes.data_ptr(), out.data_ptr(), rows, pairs,
                   float_mask, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "mapper_tables")
    launched(mapper_tables_cuda, 0)
    return out


mapper_tables_cuda.launches = 0

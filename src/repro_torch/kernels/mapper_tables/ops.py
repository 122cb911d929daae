"""The mapper's candidate tables as an op: ``chunk_tables(g)`` takes a
chunk gathered by ``core/mapper.py::_gather_chunk`` (numpy arrays, the
collapsed device scalars as Python numbers) and returns the tables of
``core/mapper.py::_tables`` as numpy arrays, bit for bit, from the kernel
``csrc/mapper_tables.cu``. There is no fallback: without a card, or where
the kernel fails to build or launch, it raises. The plain version
``ref.tables_ref`` takes ``to_tensors(g, device)``.

On the card the chunk travels as one buffer each way. ``pack`` lays out the
six tile columns column-major, the pipeline flags, and one row of scalars a
(hardware, shape) pair: the gather's per-row shape columns are read at each
pair's first row, and its collapsed hardware scalars are not densified.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from . import kernel
from .kernel import PAIR_FLOATS, PAIR_INTS, WIDTHS

_TILES = ("tm", "tk", "tn", "sm", "sk", "sn")


def empty_tables() -> Dict[str, np.ndarray]:
    """The tables of a chunk without rows, in numpy's dtypes."""
    z, zi = np.zeros(0), np.zeros(0, dtype=np.int64)
    return {"totals": np.zeros((0, 4)), "use_s2": np.zeros((0, 2), bool),
            "tile_time": np.zeros((0, 2)), "steps": zi, "step_mem_t": z,
            "c_total_t": z, "n_t_m": zi, "n_t_n": zi, "n_t_k": zi}


def _integral(name: str, v: Any) -> np.ndarray:
    a = np.asarray(v)
    if a.dtype.kind not in "iub":
        raise TypeError(f"mapper tables take {name} as integers, got {a.dtype}")
    return a.astype(np.int64)


def _sizes(n: int, pairs: int) -> Tuple[int, ...]:
    """int64 words of the packed inputs' parts, in ``pack``'s order."""
    return (6 * n, pairs + 1, len(PAIR_INTS) * pairs, len(WIDTHS) * pairs,
            len(PAIR_FLOATS) * pairs, -(-4 * n // 8))


def pack(g: Dict[str, Any]) -> Tuple[np.ndarray, int, int, int]:
    """The kernel's inputs of a gathered chunk in one int64 buffer: cols (6,
    rows), offs (pairs + 1), pint (pairs, 11), pbytes (pairs, 4), pflt
    (pairs, 3) as float64 bits, then p_ok (rows, 4) bytes. Returns (buffer,
    rows, pairs, float mask)."""
    n = int(g["tm"].size)
    offs = np.asarray(g["offs"], dtype=np.int64)
    pairs = offs.size - 1
    first = np.minimum(offs[:-1], n - 1)    # an empty pair reads any row

    def per_pair(name: str) -> np.ndarray:
        v = g[name]
        return np.full(pairs, v) if np.ndim(v) == 0 else np.asarray(v)[first]

    sizes = _sizes(n, pairs)
    ends = np.cumsum(sizes)
    buf = np.empty(int(ends[-1]), dtype=np.int64)
    parts = [buf[e - s:e] for s, e in zip(sizes, ends)]
    cols = parts[0].reshape(6, n)
    for i, name in enumerate(_TILES):
        cols[i] = g[name]
    parts[1][:] = offs
    pint = parts[2].reshape(pairs, len(PAIR_INTS))
    for i, name in enumerate(PAIR_INTS):
        pint[:, i] = _integral(name, per_pair(name))
    mask = 0
    pbytes = parts[3].reshape(pairs, len(WIDTHS))
    for i, name in enumerate(WIDTHS):
        v = per_pair(name)
        if v.dtype == np.float64:       # numpy promoted the column
            pbytes[:, i] = v.view(np.int64)
            mask |= 1 << i
        else:
            pbytes[:, i] = _integral(name, v)
    pflt = parts[4].view(np.float64).reshape(pairs, len(PAIR_FLOATS))
    for i, name in enumerate(PAIR_FLOATS):
        pflt[:, i] = per_pair(name)
    parts[5].view(np.uint8)[:4 * n] = np.asarray(g["p_ok"], dtype=bool).reshape(-1)
    return buf, n, pairs, mask


def device_args(buf: torch.Tensor, n: int, pairs: int, mask: int) -> tuple:
    """``kernel.mapper_tables_cuda``'s arguments: views of a packed buffer
    on the card."""
    parts, at = [], 0
    for size in _sizes(n, pairs):
        parts.append(buf[at:at + size])
        at += size
    return (parts[0].view(6, n), parts[5].view(torch.uint8)[:4 * n].view(n, 4), parts[1],
            parts[2].view(pairs, len(PAIR_INTS)), parts[4].view(torch.float64).view(
                pairs, len(PAIR_FLOATS)), parts[3].view(pairs, len(WIDTHS)), mask)


def unpack(out: np.ndarray, n: int) -> Dict[str, np.ndarray]:
    """numpy's tables from the kernel's packed output (uint8, n rows)."""
    f = out[:64 * n].view(np.float64)
    i = out[64 * n:96 * n].view(np.int64)
    return {"totals": f[:4 * n].reshape(n, 4),
            "use_s2": out[96 * n:98 * n].view(bool).reshape(n, 2),
            "tile_time": f[4 * n:6 * n].reshape(n, 2),
            "steps": i[:n], "step_mem_t": f[6 * n:7 * n],
            "c_total_t": f[7 * n:8 * n],
            "n_t_m": i[n:2 * n], "n_t_n": i[2 * n:3 * n], "n_t_k": i[3 * n:4 * n]}


def to_tensors(g: Dict[str, Any], device: str) -> Dict[str, torch.Tensor]:
    """The gathered chunk as per-row tensors on `device`, each column in
    numpy's dtype (``ref.tables_ref``'s input)."""
    n = int(g["tm"].size)
    out = {}
    for name in (*_TILES, *PAIR_INTS, *PAIR_FLOATS, *WIDTHS, "p_ok"):
        a = np.asarray(g[name])
        if name in PAIR_FLOATS:
            a = a.astype(np.float64)
        elif name == "b_shared" or name == "p_ok":
            a = a.astype(bool)
        elif name not in WIDTHS or a.dtype != np.float64:
            a = _integral(name, a)
        if a.ndim == 0:
            a = np.full(n, a[()], dtype=a.dtype)
        out[name] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return out


def chunk_tables(g: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """The candidate tables of a gathered chunk, computed by the kernel on
    the card, as numpy arrays equal to ``core/mapper.py::_tables(g)`` bit
    for bit. A chunk without rows launches nothing."""
    n = int(g["tm"].size)
    if n == 0:
        return empty_tables()
    buf, n, pairs, mask = pack(g)
    dev_buf = torch.from_numpy(buf).to("cuda")
    out = kernel.mapper_tables_cuda(*device_args(dev_buf, n, pairs, mask))
    return unpack(out.cpu().numpy(), n)

"""Systolic-array timing model (paper Sec. III-B1, "from local buffer to lanes").

The paper drives SCALE-Sim [56,57] per (tile, array) shape and caches results
in a look-up table. We implement the closed-form cycle count that SCALE-Sim
produces for dense GEMM in output-stationary dataflow (its default for matmul
tiles) and cache it identically. The closed form is exact for dense tiles —
SCALE-Sim itself derives cycles = fill + stream + drain for each pass:

    per-pass cycles (OS dataflow, Sr x Sc array, reduction depth k):
        2 * Sr + Sc + k - 2
    passes = ceil(m / Sr) * ceil(n / Sc)

The last partial pass uses the partial fill/drain of the occupied rows/cols,
which matters for narrow decode-time GEMMs (paper Fig. 7 analysis: "large
systolic arrays are harder to fully utilize").
"""
from __future__ import annotations

import functools

import numpy as np

from .hardware import SystolicArray
from .units import Cycles, Ratio


@functools.lru_cache(maxsize=1 << 20)
def gemm_cycles(m: int, k: int, n: int, rows: int, cols: int) -> Cycles:
    """Cycles for one lane's systolic array to compute an (m,k)x(k,n) GEMM."""
    if m <= 0 or k <= 0 or n <= 0:
        return 0
    full_r, rem_r = divmod(m, rows)
    full_c, rem_c = divmod(n, cols)

    def pass_cycles(r_occ: int, c_occ: int) -> Cycles:
        # fill (weights/partials skew in over 2*r), stream k, drain c
        return 2 * r_occ + c_occ + k - 2

    total: Cycles = 0
    total += full_r * full_c * pass_cycles(rows, cols)
    if rem_r:
        total += full_c * pass_cycles(rem_r, cols)
    if rem_c:
        total += full_r * pass_cycles(rows, rem_c)
    if rem_r and rem_c:
        total += pass_cycles(rem_r, rem_c)
    return total


def gemm_cycles_array(m, k, n, rows, cols, xp=np):
    """Vectorized version used by the mapper's parameter search.

    m, k, n: broadcastable integer arrays; rows/cols may be scalars or
    per-row arrays (the mapper's device axis). Returns int64 array of cycles.
    This is the LUT-free fast path: the closed form is cheap enough to
    evaluate for ~1e5 candidates at once, which is what makes our mapper
    ~1000x faster than a per-candidate loop (paper: 26,400 rounds in ~15 min).

    `xp` selects the array module: numpy (default) or jax.numpy — the same
    closed form serves both mapper backends (core/mapper_jax.py traces it
    into the jitted candidate-table kernel; winners are backend-independent,
    tests/test_mapper_jax.py).
    """
    m = xp.asarray(m, dtype=xp.int64)
    k = xp.asarray(k, dtype=xp.int64)
    n = xp.asarray(n, dtype=xp.int64)
    full_r, rem_r = xp.divmod(m, rows)
    full_c, rem_c = xp.divmod(n, cols)

    def pc(r_occ, c_occ):
        return 2 * r_occ + c_occ + k - 2

    total = full_r * full_c * pc(rows, cols)
    total = total + xp.where(rem_r > 0, full_c * pc(rem_r, cols), 0)
    total = total + xp.where(rem_c > 0, full_r * pc(rows, rem_c), 0)
    total = total + xp.where((rem_r > 0) & (rem_c > 0), pc(rem_r, rem_c), 0)
    return total


def utilization(m: int, k: int, n: int, sa: SystolicArray) -> Ratio:
    """MAC utilization of the array for this tile (1.0 = every PE busy)."""
    cyc: Cycles = gemm_cycles(m, k, n, sa.rows, sa.cols)
    if cyc == 0:
        return 0.0
    ideal: Cycles = m * k * n / sa.macs
    return min(1.0, ideal / cyc)

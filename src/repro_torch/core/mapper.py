"""Mapper: performance-optimal tiling + scheduling search (paper Sec. III-B1).

Simulates C[M,N] = A[M,K] @ B[K,N] (+C) on the hardware template, recursively:

  level 2: main memory -> global buffer      (tiles Tm x Tk x Tn)
  level 1: global buffer -> cores            (subtiles Sm x Sk x Sn, wave
           schedule over cores; scheme 1 = cores own distinct C subtiles with
           merged A/B reads; scheme 2 = cores split K of one C subtile and
           reduce)
  level 0: local buffer -> lanes -> systolic array (closed-form SCALE-Sim
           cycles, see systolic.py)

Double buffering (software pipeline) is a search option at levels 2 and 1: it
overlaps load with compute (latency = max instead of sum) but halves the
usable buffer capacity (paper: "the maximal tile size will be reduced").

The search is vectorized: every feasible (tile, subtile, scheme, pipeline)
candidate of a GEMM shape is priced in one numpy broadcast. Candidates that
violate a buffer or shape constraint are compressed away before the
arithmetic, and a per-row lower bound drops the rows that can neither win
nor tie before they are priced, so the winner (tie-breaks included) is the
dense search's.

This is the PyTorch port's copy of the JAX package's numpy mapper, which
`kernels/matmul/ops.mapper_blocks` asks for Hopper tile sizes through
`matmul_perf`. It keeps the search, the pruning and an in-memory
(device, shape) memo, and leaves out the JAX chunk backend, the persistent
disk layer, the pruning switch, the counters, the device-batched entry
point and the dense reference search: it reads and writes no cache entry
on disk, and for each (device, shape) gives the JAX mapper's mapping and
latency (tests/test_torch_matmul.py).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import numpy as np

from .hardware import Device
from .systolic import gemm_cycles_array
from .units import Bytes, Flops, Seconds


@dataclass(frozen=True)
class Mapping:
    """Best mapping found by the search — also the Pallas BlockSpec hint."""
    tile_m: int
    tile_k: int
    tile_n: int
    subtile_m: int
    subtile_k: int
    subtile_n: int
    scheme: int                  # 1: output-parallel, 2: k-split + reduce
    double_buffer_l2: bool
    double_buffer_l1: bool
    compute_time: Seconds
    memory_time: Seconds

    @property
    def bound(self) -> str:
        return "compute" if self.compute_time >= self.memory_time else "memory"


@dataclass(frozen=True)
class MatmulResult:
    latency: Seconds             # excluding kernel launch overhead
    flops: Flops
    main_memory_bytes: Bytes
    mapping: Mapping
    candidates_searched: int


# GEMM shape tuple the search takes (per-operand byte
# widths + narrow-datatype compute rate):
#   (m, k, n, batch, bytes_a, bytes_b, bytes_out, bytes_acc, b_shared,
#    mac_scale)
# bytes_a prices the A (activation) stream, bytes_b the B (weight / KV)
# stream, bytes_out the written C, bytes_acc the on-chip staging of C tiles
# and k-split partials. mac_scale divides systolic cycle counts (power of
# two: exact). All-2 widths with mac_scale 1.0 reproduce the seed search
# bit-for-bit.
MatmulShape = Tuple[int, int, int, int, float, float, float, float, bool,
                    float]


def _tile_candidates(dim: int, align: int, max_tiles: int = 12) -> np.ndarray:
    """Power-of-two-ish candidate tile sizes for one dimension.

    The set always contains the full dimension (max reuse) and, for every
    dim/align ratio within the `max_tiles` doubling budget (< ~2^11 —
    everything the framework's model graphs generate below ~50k-token LM
    heads), the hardware-native alignment tile (one systolic-array pass /
    the k-blocking granularity). Beyond the budget the LARGEST tiles are
    kept, which drops the native tile: that truncation is pinned by the
    frozen fp16 seed references (tests/data/seed_reference.json) — forcing
    the native tile back in finds slightly better mappings for huge
    embedding/LM-head GEMMs and would change frozen winners, so it must
    ride a model-version bump, not a perf PR. Coverage is asserted in
    tests/test_mapper_prune.py."""
    cands = {dim}
    t = align
    while t < dim:
        cands.add(t)
        t *= 2
    # multiples of align near dim for better edge packing
    if dim > align:
        cands.add((dim + align - 1) // align * align)
    out = np.array(sorted(c for c in cands if c > 0), dtype=np.int64)
    if len(out) > max_tiles:           # keep the largest (most reuse) ones
        out = out[-max_tiles:]
    return out


# pipeline options p = (db2, db1), in the dense search's axis order
_DB_OPTIONS = ((0, 0), (0, 1), (1, 0), (1, 1))


def _candidate_rows(dev: Device, shape: MatmulShape
                    ) -> Tuple[Tuple[Any, ...], Any, int]:
    """Feasible (tile, subtile) pairs for one GEMM shape, in dense-search
    order (level-2 index major, level-1 minor). Returns the gathered flat
    candidate arrays plus per-pipeline validity columns."""
    m, k, n, batch, bytes_a, bytes_b, bytes_out, bytes_acc, _, _ = shape
    sa = dev.core.lane.systolic_array

    tm = _tile_candidates(m, min(sa.rows, m))
    tk = _tile_candidates(k, min(128, k))
    tn = _tile_candidates(n, min(sa.cols, n))
    sm = _tile_candidates(m, min(sa.rows, m))
    sk = _tile_candidates(k, min(64, k))
    sn = _tile_candidates(n, min(sa.cols, n))

    TM, TK, TN = np.meshgrid(tm, tk, tn, indexing="ij")
    TM, TK, TN = TM.ravel(), TK.ravel(), TN.ravel()
    SM, SK, SN = np.meshgrid(sm, sk, sn, indexing="ij")
    SM, SK, SN = SM.ravel(), SK.ravel(), SN.ravel()

    # buffer residency: A/B tiles at their stream widths, C tiles at the
    # accumulator width they are staged at
    gb_need = TM * TK * bytes_a + TK * TN * bytes_b + TM * TN * bytes_acc
    lb_need = SM * SK * bytes_a + SK * SN * bytes_b + SM * SN * bytes_acc
    gb_ok = (gb_need[:, None] * (1 + np.array([0, 1], dtype=np.int64))
             <= dev.global_buffer_bytes)            # [i2, db2]
    lb_ok = (lb_need[:, None] * (1 + np.array([0, 1], dtype=np.int64))
             <= dev.core.local_buffer_bytes)        # [i1, db1]

    pair_ok = (SM[None, :] <= TM[:, None]) & (SK[None, :] <= TK[:, None]) \
        & (SN[None, :] <= TN[:, None])
    if batch > 1:
        # subtiles/tiles must not span batch elements
        pair_ok = pair_ok & (SM[None, :] <= m) & (TM[:, None] <= m)
    pair_ok = pair_ok & gb_ok.any(axis=1)[:, None] & lb_ok.any(axis=1)[None, :]

    i2, i1 = np.nonzero(pair_ok)
    n_dense = TM.size * SM.size * len(_DB_OPTIONS)
    cols = (TM[i2], TK[i2], TN[i2], SM[i1], SK[i1], SN[i1])
    p_ok = np.stack([gb_ok[i2, db2] & lb_ok[i1, db1]
                     for db2, db1 in _DB_OPTIONS], axis=1)   # [rows, p]
    return cols, p_ok, n_dense


def _gather(dev: Device, shape: MatmulShape, cols: Tuple[Any, ...],
            p_ok: Any) -> Dict[str, Any]:
    """One (device, shape) pair's candidate rows as the flat arrays the
    tables read: device scalars as Python numbers, shape scalars repeated
    per row (int64, float64 where a byte width is fractional), as the JAX
    package gathers them, so both price every row with the same operations."""
    rows = cols[0].size

    def per_row(v: Any, dtype: Any = np.int64) -> Any:
        if dtype is np.int64 and v != int(v):
            dtype = np.float64
        return np.full(rows, v, dtype=dtype)

    m, k, n, batch, bytes_a, bytes_b, bytes_out, bytes_acc, b_shared, \
        mac_scale = shape
    sa = dev.core.lane.systolic_array
    return {
        "tm": cols[0], "tk": cols[1], "tn": cols[2],
        "sm": cols[3], "sk": cols[4], "sn": cols[5], "p_ok": p_ok,
        "sa_rows": sa.rows, "sa_cols": sa.cols, "lanes": dev.core.lanes,
        "freq": dev.frequency_hz, "cores": dev.core_count,
        "gb_bw_cyc": dev.global_buffer_bw_per_cycle,
        "mem_bw": dev.memory_bandwidth,
        "vec_tp": dev.core.lanes * dev.core.lane.vector_unit.width,
        "m": per_row(m), "k": per_row(k), "n": per_row(n),
        "batch": per_row(batch),
        "bytes_a": per_row(bytes_a), "bytes_b": per_row(bytes_b),
        "bytes_out": per_row(bytes_out), "bytes_acc": per_row(bytes_acc),
        "b_shared": per_row(b_shared, dtype=bool),
        "mac_scale": per_row(mac_scale, dtype=np.float64),
    }


def _tables(g: Dict[str, Any]) -> Dict[str, Any]:
    """Price every candidate row of a gathered pair.

    Returns the per-row tables the winner pick reads: `totals` [rows, p]
    (np.inf where the pipeline option is infeasible), `use_s2` / `tile_time`
    [rows, db1], and the level-2 step/traffic columns.
    """
    TM_, TK_, TN_ = g["tm"], g["tk"], g["tn"]
    SM_, SK_, SN_ = g["sm"], g["sk"], g["sn"]
    P_OK = g["p_ok"]
    sa_rows, sa_cols, lanes = g["sa_rows"], g["sa_cols"], g["lanes"]
    freq, cores, gb_bw_cyc = g["freq"], g["cores"], g["gb_bw_cyc"]
    mem_bw, vec_tp = g["mem_bw"], g["vec_tp"]
    m_v, k_v, n_v, batch_v = g["m"], g["k"], g["n"], g["batch"]
    bytes_a_v, bytes_b_v = g["bytes_a"], g["bytes_b"]
    bytes_out_v, bytes_acc_v = g["bytes_out"], g["bytes_acc"]
    bshared_v, mac_scale_v = g["b_shared"], g["mac_scale"]

    # ---------------- level 0: core compute time for one subtile ----------
    sn_lane = -(-SN_ // lanes)           # ceil: subtile split across lanes
    subtile_cyc = gemm_cycles_array(SM_, SK_, sn_lane, sa_rows, sa_cols)
    # narrow-datatype issue rate (power-of-two scale: division is exact)
    subtile_cyc = np.ceil(subtile_cyc / mac_scale_v).astype(np.int64)

    # ---------------- level 1: schedule subtiles across cores -------------
    n_sub_m = -(-TM_ // SM_)
    n_sub_n = -(-TN_ // SN_)
    n_sub_k = -(-TK_ // SK_)

    # -- scheme 1: distinct C subtiles per core, k-loop inside core --------
    out_subtiles = n_sub_m * n_sub_n
    waves = -(-out_subtiles // cores)
    w = np.minimum(out_subtiles, cores)
    gm = np.minimum(n_sub_m,
                    np.maximum(1, np.round(np.sqrt(w))).astype(np.int64))
    gn = np.minimum(n_sub_n, np.maximum(1, -(-w // gm)))
    wave_traffic = gm * SM_ * TK_ * bytes_a_v + gn * TK_ * SN_ * bytes_b_v \
        + gm * gn * SM_ * SN_ * bytes_out_v
    wave_mem_cyc = -(-wave_traffic // gb_bw_cyc)
    wave_cmp_cyc = n_sub_k * subtile_cyc
    s1_db0 = waves * (wave_mem_cyc + wave_cmp_cyc)
    s1_db1 = waves * np.maximum(wave_mem_cyc, wave_cmp_cyc) \
        + np.minimum(wave_mem_cyc, wave_cmp_cyc)

    # -- scheme 2: split K of each C subtile across spare cores ------------
    ck = np.maximum(1, np.minimum(cores // np.maximum(out_subtiles, 1),
                                  n_sub_k))
    k_per_core = -(-n_sub_k // ck)
    s2_cmp_cyc = k_per_core * subtile_cyc
    red_traffic = (2 * (ck - 1)) * SM_ * SN_ * bytes_acc_v
    red_cyc = -(-red_traffic // gb_bw_cyc) + \
        -(-((ck - 1) * SM_ * SN_) // np.maximum(vec_tp * cores, 1))
    s2_waves = -(-(out_subtiles * ck) // cores)
    s2_traffic = SM_ * TK_ * bytes_a_v + TK_ * SN_ * bytes_b_v
    s2_mem_cyc = -(-(s2_traffic * out_subtiles
                     // np.maximum(s2_waves, 1)) // gb_bw_cyc)
    s2_db0 = s2_waves * (s2_mem_cyc + s2_cmp_cyc) + red_cyc
    s2_db1 = s2_waves * np.maximum(s2_mem_cyc, s2_cmp_cyc) + red_cyc

    use_s2 = (s2_db0 < s1_db0, s2_db1 < s1_db1)
    tile_time = (np.where(use_s2[0], s2_db0, s1_db0) / freq,
                 np.where(use_s2[1], s2_db1, s1_db1) / freq)

    # ---------------- level 2: main memory <-> global buffer --------------
    n_t_m = -(-m_v // np.minimum(TM_, m_v))
    n_t_n = -(-n_v // np.minimum(TN_, n_v))
    n_t_k = -(-k_v // np.minimum(TK_, k_v))
    steps = batch_v * n_t_m * n_t_n * n_t_k
    a_bytes_step = TM_ * TK_ * bytes_a_v
    b_bytes_step = TK_ * TN_ * bytes_b_v
    c_bytes_tile = TM_ * TN_ * bytes_out_v
    # B re-read only once per k-sweep regardless of batch when b_shared
    step_mem_t = np.where(bshared_v & (batch_v > 1),
                          (a_bytes_step + b_bytes_step / batch_v) / mem_bw,
                          (a_bytes_step + b_bytes_step) / mem_bw)
    c_mem_t = c_bytes_tile / mem_bw
    c_total_t = batch_v * n_t_m * n_t_n * c_mem_t

    totals = np.empty((TM_.size, len(_DB_OPTIONS)))
    for p, (db2, db1) in enumerate(_DB_OPTIONS):
        tt = tile_time[db1]
        if db2:
            tot = steps * np.maximum(step_mem_t, tt) + c_total_t \
                + np.minimum(step_mem_t, tt)
        else:
            tot = steps * (step_mem_t + tt) + c_total_t
        totals[:, p] = np.where(P_OK[:, p], tot, np.inf)

    return {"totals": totals,
            "use_s2": np.stack(use_s2, axis=1),
            "tile_time": np.stack(tile_time, axis=1),
            "steps": steps, "step_mem_t": step_mem_t,
            "c_total_t": c_total_t,
            "n_t_m": n_t_m, "n_t_n": n_t_n, "n_t_k": n_t_k}


def _winner(g: Dict[str, Any], t: Dict[str, Any], dev: Device,
            shape: MatmulShape) -> Tuple[float, int, int, Mapping]:
    """The best candidate of the priced rows (the first on a tie):
    (latency, flops, main-memory bytes, mapping)."""
    TM_, TK_, TN_ = g["tm"], g["tk"], g["tn"]
    SM_, SK_, SN_ = g["sm"], g["sk"], g["sn"]
    totals, use_s2, tile_time = t["totals"], t["use_s2"], t["tile_time"]
    steps, step_mem_t, c_total_t = t["steps"], t["step_mem_t"], t["c_total_t"]
    n_t_m, n_t_n, n_t_k = t["n_t_m"], t["n_t_n"], t["n_t_k"]
    m, k, n, batch, bytes_a, bytes_b, bytes_out, _, _, _ = shape
    if totals.size == 0 or not np.isfinite(totals).any():
        raise ValueError(
            f"no valid mapping for matmul {m}x{k}x{n} on {dev.name} "
            f"(buffers too small?)")
    flat = int(np.argmin(totals))
    row, p = flat // totals.shape[1], flat % totals.shape[1]
    db2, db1 = _DB_OPTIONS[p]
    mm_bytes = int(batch * int(n_t_m[row] * n_t_n[row] * n_t_k[row])
                   * (int(TM_[row] * TK_[row]) * bytes_a
                      + int(TK_[row] * TN_[row]) * bytes_b)
                   + batch * int(n_t_m[row] * n_t_n[row])
                   * int(TM_[row] * TN_[row]) * bytes_out)
    mapping = Mapping(
        tile_m=int(TM_[row]), tile_k=int(TK_[row]), tile_n=int(TN_[row]),
        subtile_m=int(SM_[row]), subtile_k=int(SK_[row]),
        subtile_n=int(SN_[row]),
        scheme=2 if bool(use_s2[row, db1]) else 1,
        double_buffer_l2=bool(db2), double_buffer_l1=bool(db1),
        compute_time=float(steps[row] * tile_time[row, db1]),
        memory_time=float(steps[row] * step_mem_t[row] + c_total_t[row]),
    )
    return float(totals[row, p]), 2 * batch * m * k * n, mm_bytes, mapping


# ---------------------------------------------------------------------------
# candidate pruning
# ---------------------------------------------------------------------------
#
# Most feasible rows can be discarded without pricing them: a per-row
# analytic LOWER BOUND on the total latency — the level-2 memory time
# (identical formulas to the tables, which every pipeline option only adds
# to) combined with the device's compute roofline (a row-independent floor:
# the systolic array cannot retire more than rows*cols MACs per cycle per
# lane) — compared against an incumbent obtained by exactly pricing a
# handful of seed rows. A row whose lower bound exceeds the incumbent can
# neither win nor tie, so dropping it preserves the first-argmin winner
# bit-for-bit, including tie-breaks. `MatmulResult.candidates_searched`
# stays the dense-equivalent count (it describes the search SPACE, not the
# work done).

#: relative slack on the lower-bound cutoff. The bound is exactly (monotone
#: FP) below every total, so any positive slack is safe; 2^-40 is the JAX
#: package's value, kept so that both prune the same rows.
_PRUNE_EPS = 2.0 ** -40

#: seed rows exactly priced per pair to establish the incumbent
_PRUNE_SEEDS = 4


def _row_lower_bounds(dev: Device, shape: MatmulShape,
                      cols: Tuple[Any, ...]) -> Any:
    """Per-candidate-row lower bound (Seconds) on the total latency of one
    (device, shape) pair's rows.

    Memory floor: the level-2 step/write-back time, computed with the SAME
    expressions (and operand values) as `_tables` — every
    pipeline option adds non-negative compute/overlap terms to it, and FP
    monotonicity keeps the computed tables >= this computed bound.
    Compute floor: per-row subtile pass structure without the full
    `gemm_cycles_array` — a subtile's systolic cycles are at least
    `passes * (SK + 1)` (each pass pays its K-loop plus >= 1 fill/drain
    cycle) and at least its MAC count over the array's peak rate; both
    schemes schedule at least `n_sub_m * n_sub_n * n_sub_k` subtile
    computations over `cores` cores (every ceil in the tables only rounds
    up from these ratios), and every pipeline option's total is >= steps *
    tile compute time. The global roofline MACs / peak keeps the floor
    exact-shape-aware. Both floors under-estimate the true totals in exact
    arithmetic; `_PRUNE_EPS` absorbs the FP divergence."""
    TM_, TK_, TN_ = cols[0], cols[1], cols[2]
    SM_, SK_, SN_ = cols[3], cols[4], cols[5]
    m, k, n, batch, bytes_a, bytes_b, bytes_out, _, b_shared, mac_scale \
        = shape
    n_t_m = -(-m // np.minimum(TM_, m))
    n_t_n = -(-n // np.minimum(TN_, n))
    n_t_k = -(-k // np.minimum(TK_, k))
    steps = batch * n_t_m * n_t_n * n_t_k
    a_bytes_step = TM_ * TK_ * bytes_a
    b_bytes_step = TK_ * TN_ * bytes_b
    c_bytes_tile = TM_ * TN_ * bytes_out
    mem_bw = dev.memory_bandwidth
    if b_shared and batch > 1:
        step_mem_t = (a_bytes_step + b_bytes_step / batch) / mem_bw
    else:
        step_mem_t = (a_bytes_step + b_bytes_step) / mem_bw
    c_mem_t = c_bytes_tile / mem_bw
    c_total_t = batch * n_t_m * n_t_n * c_mem_t
    lb_mem = steps * step_mem_t + c_total_t

    sa = dev.core.lane.systolic_array
    lanes = dev.core.lanes
    cores = dev.core_count
    freq = dev.frequency_hz
    n_sub = (-(-TM_ // SM_)) * (-(-TN_ // SN_)) * (-(-TK_ // SK_))
    sn_lane = -(-SN_ // lanes)
    passes = (-(-SM_ // sa.rows)) * (-(-sn_lane // sa.cols))
    sub_cyc = np.maximum(passes * (SK_ + 1),
                         SM_ * SK_ * sn_lane / (sa.rows * sa.cols))
    lb_cmp_row = steps * (n_sub * sub_cyc / (mac_scale * cores * freq))
    peak_macs = float(cores) * lanes * sa.rows * sa.cols * mac_scale * freq
    lb_cmp = batch * m * k * n / peak_macs
    return np.maximum(lb_mem, np.maximum(lb_cmp_row, lb_cmp))


def _seed_rows(lb: Any) -> Any:
    """Indices of the rows exactly priced to establish the incumbent: the
    _PRUNE_SEEDS smallest lower bounds (most promising) plus the last row
    (largest tiles on every axis — the usual compute-bound winner)."""
    n = int(lb.size)
    picks = set(np.argsort(lb, kind="stable")[:min(_PRUNE_SEEDS, n)].tolist())
    picks.add(n - 1)
    return np.array(sorted(picks), dtype=np.int64)


def _prune(dev: Device, shape: MatmulShape, cols: Tuple[Any, ...],
           p_ok: Any) -> Tuple[Tuple[Any, ...], Any]:
    """Lower-bound cutoff: exactly price the seed rows, then keep only rows
    whose bound does not exceed that incumbent. Winner-preserving: the
    winning row's bound never exceeds its own total, which never exceeds
    the incumbent; relative row order is kept, so the first-argmin
    tie-break is unchanged."""
    lb = _row_lower_bounds(dev, shape, cols)
    ix = _seed_rows(lb)
    seeds = _gather(dev, shape, tuple(c[ix] for c in cols), p_ok[ix])
    inc = float(np.min(_tables(seeds)["totals"]))
    keep = lb <= inc * (1.0 + _PRUNE_EPS)
    return tuple(c[keep] for c in cols), p_ok[keep]


@functools.lru_cache(maxsize=1 << 12)
def _search(device: Device, shape: MatmulShape) -> MatmulResult:
    """The mapper's search for one (device, shape) pair, memoized."""
    cols, p_ok, n_dense = _candidate_rows(device, shape)
    if cols[0].size:
        cols, p_ok = _prune(device, shape, cols, p_ok)
    g = _gather(device, shape, cols, p_ok)
    lat, flops, mm_bytes, mapping = _winner(g, _tables(g), device, shape)
    return MatmulResult(latency=lat, flops=flops, main_memory_bytes=mm_bytes,
                        mapping=mapping, candidates_searched=n_dense)


def matmul_perf(device: Device, m: int, k: int, n: int,
                batch: int = 1, bytes_a: float = 2, bytes_b: float = 2,
                bytes_out: float = 2, bytes_acc: float = 2,
                b_shared: bool = False,
                mac_scale: float = 1.0) -> MatmulResult:
    """Search the mapping space and return the best predicted latency.
    Memoized per (device, shape).

    batch: independent GEMM instances (e.g. B*H for attention score GEMMs).
      The batch dimension folds into M for scheduling (subtiles never span
      batch elements) and multiplies B-operand traffic unless b_shared.
    b_shared: all batch elements share one B operand (weight matmul with the
      activation batch folded into M should instead pass batch=1, m=B*M).
    bytes_a/bytes_b/bytes_out/bytes_acc, mac_scale: per-operand widths and
      narrow-datatype issue rate — see MatmulShape.
    """
    return _search(device, (m, k, n, batch, bytes_a, bytes_b, bytes_out,
                            bytes_acc, b_shared, mac_scale))

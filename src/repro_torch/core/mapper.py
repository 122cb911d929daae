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

The search is vectorized and batched: every feasible (tile, subtile, scheme,
pipeline) candidate of every requested GEMM shape is priced in one pass over
a flat pairs x candidates axis (`matmul_perf_batch_multi`). Candidates that
violate a buffer or shape constraint are compressed away before the
arithmetic, and a per-row lower bound drops the rows that can neither win
nor tie before they are priced, so each winner (tie-breaks included) is the
dense search's (`matmul_perf_reference`). Every hardware scalar the cost
model reads is gathered per candidate row like the shape scalars, so one
pass prices (device, shape) pairs across a whole design-space Study.

A chunk is evaluated in three steps: a gather (`_gather_chunk`), the
candidate tables, and a winner pick (`_pick_winners`). The tables run where
the caller says: ``device="cpu"`` runs the numpy `_tables`, ``"cuda"`` the
hand-written kernel ``kernels/mapper_tables`` (``csrc/mapper_tables.cu``,
one thread a row), whose every output column is `_tables`' bit for bit.
Without a card, ``"cuda"`` raises; nothing falls back to the CPU. The
per-shape `matmul_perf`, which ``kernels/matmul/ops.mapper_blocks`` asks
for Hopper tiles, runs the same search on numpy and memoizes it per process.

Results persist: the batched entry points keep a bounded in-memory (device,
shape) LRU backed by a content-hashed on-disk cache (core/result_cache.py)
keyed by sha256(model-version salt, table device, Device, MatmulShape), so
a new process re-reads earlier searches instead of solving them again.

This is the PyTorch port's copy of the JAX package's mapper; for each
(device, shape) it gives the JAX mapper's mapping and latency
(tests/test_torch_matmul.py, tests/test_torch_mapper_tables.py).
"""
from __future__ import annotations

import functools
import os
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, ClassVar, Dict, List, Optional, Sequence, Tuple, cast

import numpy as np

from .hardware import Device
from .obs import metrics
from .result_cache import MODEL_VERSION, DiskCache, content_key
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


# GEMM shape tuple accepted by matmul_perf_batch (per-operand byte widths +
# narrow-datatype compute rate):
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


def _gather_chunk(devs: Sequence[Device], shapes: Sequence[MatmulShape],
                  rows: Sequence[Any], p_oks: Sequence[Any]
                  ) -> Dict[str, Any]:
    """Concatenate the feasible candidates of several (device, shape) pairs
    into flat per-row arrays — the input of the chunk
    evaluation on either table device. Device and shape scalars are gathered per candidate row;
    uniform device scalars collapse to python scalars so the single-device
    path stays cheap (bit-identical either way: numpy broadcasting of an
    equal-valued array)."""
    counts = [r[0].size for r in rows]
    offs = np.concatenate([[0], np.cumsum(counts)])

    def dscal(vals: Sequence[Any], dtype: Any = np.int64) -> Any:
        if len(set(vals)) == 1:
            return vals[0]
        return np.concatenate([np.full(c, v, dtype=dtype)
                               for c, v in zip(counts, vals)])

    # per-row gathered shape scalars (byte widths promote to float64 only
    # when a sub-byte width appears, keeping the default path on exact int64)
    def scal(idx: int, dtype: Any = np.int64) -> Any:
        vals = [s[idx] for s in shapes]
        if dtype is np.int64 and any(v != int(v) for v in vals):
            dtype = np.float64
        return np.concatenate([np.full(c, v, dtype=dtype)
                               for c, v in zip(counts, vals)])

    tm, tk, tn, sm, sk, sn = (np.concatenate([r[j] for r in rows])
                              for j in range(6))
    return {
        "counts": counts, "offs": offs,
        "tm": tm, "tk": tk, "tn": tn, "sm": sm, "sk": sk, "sn": sn,
        "p_ok": (np.concatenate(p_oks, axis=0) if p_oks
                 else np.zeros((0, 4), bool)),
        "sa_rows": dscal([d.core.lane.systolic_array.rows for d in devs]),
        "sa_cols": dscal([d.core.lane.systolic_array.cols for d in devs]),
        "lanes": dscal([d.core.lanes for d in devs]),
        "freq": dscal([d.frequency_hz for d in devs], dtype=np.float64),
        "cores": dscal([d.core_count for d in devs]),
        "gb_bw_cyc": dscal([d.global_buffer_bw_per_cycle for d in devs]),
        "mem_bw": dscal([d.memory_bandwidth for d in devs],
                        dtype=np.float64),
        "vec_tp": dscal([d.core.lanes * d.core.lane.vector_unit.width
                         for d in devs]),
        "m": scal(0), "k": scal(1), "n": scal(2), "batch": scal(3),
        "bytes_a": scal(4), "bytes_b": scal(5),
        "bytes_out": scal(6), "bytes_acc": scal(7),
        "b_shared": scal(8, dtype=bool),
        "mac_scale": scal(9, dtype=np.float64),
    }


def _tables(g: Dict[str, Any]) -> Dict[str, Any]:
    """Price every candidate row of a gathered chunk with numpy.

    Returns the per-row tables the winner pick reads: `totals` [rows, p]
    (np.inf where the pipeline option is infeasible), `use_s2` / `tile_time`
    [rows, db1], and the level-2 step/traffic columns. The kernel of
    ``kernels/mapper_tables`` computes the same tables on the card.
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


def _pick_winners(g: Dict[str, Any], t: Dict[str, Any],
                  devs: Sequence[Device],
                  shapes: Sequence[MatmulShape]) -> List[Tuple[Any, ...]]:
    """Select each pair's best candidate from the chunk tables (pure numpy
    over the returned tables, whichever device computed them)."""
    offs = g["offs"]
    TM_, TK_, TN_ = g["tm"], g["tk"], g["tn"]
    SM_, SK_, SN_ = g["sm"], g["sk"], g["sn"]
    totals, use_s2, tile_time = t["totals"], t["use_s2"], t["tile_time"]
    steps, step_mem_t, c_total_t = t["steps"], t["step_mem_t"], t["c_total_t"]
    n_t_m, n_t_n, n_t_k = t["n_t_m"], t["n_t_n"], t["n_t_k"]

    out: List[Tuple[Any, ...]] = []
    for s, shape in enumerate(shapes):
        lo, hi = int(offs[s]), int(offs[s + 1])
        seg = totals[lo:hi]
        if seg.size == 0 or not np.isfinite(seg).any():
            m, k, n = shape[0], shape[1], shape[2]
            raise ValueError(
                f"no valid mapping for matmul {m}x{k}x{n} on {devs[s].name} "
                f"(buffers too small?)")
        flat = int(np.argmin(seg))
        row, p = lo + flat // seg.shape[1], flat % seg.shape[1]
        db2, db1 = _DB_OPTIONS[p]
        m, k, n, batch, bytes_a, bytes_b, bytes_out, _, _, _ = shape
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
        out.append((float(totals[row, p]), 2 * batch * m * k * n, mm_bytes,
                    mapping))
    return out


# ---------------------------------------------------------------------------
# where the tables run
# ---------------------------------------------------------------------------

#: where the batched entry points price a chunk's candidate tables
TABLE_DEVICES = ("cpu", "cuda")

#: the disk key's salt per table device (the JAX package salts with its
#: backend name, "numpy" for the same tables)
_DISK_SALT = {"cpu": "numpy", "cuda": "cuda"}


def check_device(device: str) -> str:
    """Validate a table device: ``"cpu"``, or ``"cuda"`` with a card. Raises
    instead of falling back."""
    if device not in TABLE_DEVICES:
        raise ValueError(f"unknown mapper table device {device!r}; "
                         f"have {TABLE_DEVICES}")
    if device == "cuda":
        import torch
        if not torch.cuda.is_available():
            raise RuntimeError(
                "mapper tables on device='cuda' need a CUDA card; pass "
                "device='cpu' to price them with numpy")
    return device


def _chunk_tables(g: Dict[str, Any], device: str) -> Dict[str, Any]:
    """Candidate tables of one gathered chunk on `device`. Every evaluated
    row is counted (`mapper.rows_evaluated`), against `mapper.rows_feasible`
    to report how much of the dense-equivalent search was paid for, and
    every call (`mapper.table_calls_<device>`), the pruning's seed chunks
    included."""
    _REG.inc("mapper.rows_evaluated", float(g["tm"].size))
    _REG.inc(f"mapper.table_calls_{device}")
    with _REG.phase("mapper.tables"):
        if device == "cuda":
            from ..kernels.mapper_tables.ops import chunk_tables
            return chunk_tables(g)
        return _tables(g)


def _pair_sig(dev: Device, shape: MatmulShape) -> Tuple[Any, ...]:
    """Everything the candidate generation + cost tables read from a
    (device, shape) pair. Two pairs with equal signatures have identical
    candidate rows and identical per-row tables — e.g. devices differing
    only in name, memory capacity, or launch overhead — so one is solved
    and the winner reused (`_solve_chunk` dedupe)."""
    sa = dev.core.lane.systolic_array
    return (shape, sa.rows, sa.cols, dev.core.lanes, dev.frequency_hz,
            dev.core_count, dev.global_buffer_bw_per_cycle,
            dev.memory_bandwidth, dev.core.lane.vector_unit.width,
            dev.global_buffer_bytes, dev.core.local_buffer_bytes)


def _solve_chunk(devs: Sequence[Device], shapes: Sequence[MatmulShape],
                 rows: Sequence[Any], p_oks: Sequence[Any], device: str
                 ) -> List[Tuple[Any, ...]]:
    """Evaluate the concatenated feasible candidates of several (device,
    shape) pairs in one pass and pick each pair's winner. Returns per-pair
    winner tuples. `devs[i]` is the hardware of `shapes[i]`; `device` is
    where the tables run.

    Pairs whose cost signatures coincide (`_pair_sig`) contribute their
    candidate rows once; duplicates reuse the solved winner (exact — the
    tables are a pure per-row function of the signature). Dedupe is part
    of the pruning layer and is bypassed when pruning is "off"."""
    uniq: Dict[Tuple[Any, ...], int] = {}
    owner: List[int] = []
    first: List[int] = []
    if _PRUNE != "off" and len(shapes) > 1:
        with _REG.phase("mapper.prune"):
            for j in range(len(shapes)):
                sig = _pair_sig(devs[j], shapes[j])
                at = uniq.get(sig)
                if at is None:
                    uniq[sig] = len(first)
                    owner.append(len(first))
                    first.append(j)
                else:
                    owner.append(at)
                    _REG.inc("mapper.rows_deduped", float(rows[j][0].size))
    else:
        first = list(range(len(shapes)))
        owner = first
    with _REG.phase("mapper.gather"):
        g = _gather_chunk([devs[j] for j in first],
                          [shapes[j] for j in first],
                          [rows[j] for j in first], [p_oks[j] for j in first])
    tables = _chunk_tables(g, device)
    with _REG.phase("mapper.winners"):
        won = _pick_winners(g, tables, [devs[j] for j in first],
                            [shapes[j] for j in first])
    return [won[o] for o in owner]


# candidate-row budget per chunk (~25 work arrays x 8B x rows on numpy).
# 64k rows keeps the chunk working set ~10-15MB — cache-resident on the
# host; winners are chunk-composition-independent, so this only moves
# wall-clock, never results.
_CHUNK_ROWS = 1 << 16


# ---------------------------------------------------------------------------
# candidate pruning
# ---------------------------------------------------------------------------
#
# The batched search evaluates every feasible candidate row. Most rows can
# be discarded without pricing them: a per-row analytic LOWER BOUND on the
# total latency — the level-2 memory time (identical formulas to the
# tables, which every pipeline option only adds to) combined with the
# device's compute roofline (a row-independent floor: the systolic array
# cannot retire more than rows*cols MACs per cycle per lane) — compared
# against an incumbent obtained by exactly pricing a handful of seed rows.
# A row whose lower bound exceeds the incumbent can neither win nor tie,
# so dropping it preserves the first-argmin winner bit-for-bit, including
# tie-breaks. `MatmulResult.candidates_searched` stays the dense-equivalent
# count either way (it describes the search SPACE, not the work done);
# the work actually paid for is reported via the registry counters
# `mapper.rows_feasible` / `mapper.rows_evaluated` / `mapper.rows_pruned`
# / `mapper.rows_deduped`.
#
# Modes: "on" (default) prunes; "off" restores the exhaustive path;
# "oracle" prunes AND re-solves the full row set, asserting the winners
# are identical (the same guarantee discipline as matmul_perf_reference).

_PRUNE_MODES = ("on", "off", "oracle")
_PRUNE = os.environ.get("REPRO_MAPPER_PRUNE", "on").strip().lower()
if _PRUNE not in _PRUNE_MODES:
    _PRUNE = "on"

#: relative slack on the lower-bound cutoff. The bound is exactly (monotone
#: FP) below every total on both table devices (the kernel contracts no
#: a*b + c into an FMA), so any positive slack is safe; 2^-40 is the JAX
#: package's value, kept so that both prune the same rows.
_PRUNE_EPS = 2.0 ** -40

#: seed rows exactly priced per pair to establish the incumbent
_PRUNE_SEEDS = 4


def get_mapper_prune() -> str:
    """The active pruning mode ("on" | "off" | "oracle")."""
    return _PRUNE


def set_mapper_prune(mode: str) -> str:
    """Select the candidate-pruning mode; returns the previous one.

    "on" (default; or REPRO_MAPPER_PRUNE) applies the lower-bound cutoff
    and cross-pair row dedupe, "off" restores the exhaustive evaluation,
    "oracle" runs both and raises if any winner differs — winners are
    bit-for-bit identical in all three modes."""
    global _PRUNE
    if mode not in _PRUNE_MODES:
        raise ValueError(f"unknown mapper prune mode {mode!r}; "
                         f"have {_PRUNE_MODES}")
    prev = _PRUNE
    _PRUNE = mode
    return prev


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


def _prune_pairs(devs: Sequence[Device], shapes: Sequence[MatmulShape],
                 rows: Sequence[Any], p_oks: Sequence[Any], device: str
                 ) -> Tuple[List[Tuple[Any, ...]], List[Any], int]:
    """Lower-bound cutoff over a pending chunk: exactly price each pair's
    seed rows (one table call on `device` for the whole chunk), then keep
    only rows whose bound does not exceed that incumbent. Returns the
    per-pair kept rows/validity columns and the number of rows pruned.
    Winner-preserving: the winning row's bound never exceeds its own total,
    which never exceeds the incumbent; relative row order is kept, so the
    first-argmin tie-break is unchanged."""
    with _REG.phase("mapper.prune"):
        lbs = [_row_lower_bounds(d, s, r)
               for d, s, r in zip(devs, shapes, rows)]
        seeds = [_seed_rows(lb) for lb in lbs]
        seed_rows = [tuple(c[ix] for c in r) for r, ix in zip(rows, seeds)]
        seed_poks = [p[ix] for p, ix in zip(p_oks, seeds)]
    with _REG.phase("mapper.gather"):
        g = _gather_chunk(devs, shapes, seed_rows, seed_poks)
    totals = _chunk_tables(g, device)["totals"]
    offs = g["offs"]
    kept_rows: List[Tuple[Any, ...]] = []
    kept_poks: List[Any] = []
    n_pruned = 0
    with _REG.phase("mapper.prune"):
        for j, (r, p, lb) in enumerate(zip(rows, p_oks, lbs)):
            inc = float(np.min(totals[int(offs[j]):int(offs[j + 1])]))
            keep = lb <= inc * (1.0 + _PRUNE_EPS)
            n_pruned += int(r[0].size - np.count_nonzero(keep))
            kept_rows.append(tuple(c[keep] for c in r))
            kept_poks.append(p[keep])
    return kept_rows, kept_poks, n_pruned


# ---------------------------------------------------------------------------
# result memo: bounded in-memory LRU backed by the persistent disk layer
# ---------------------------------------------------------------------------

_REG = metrics()


class MapperCacheStats:
    """Accounting for the two memo layers (the evaluator snapshots the
    deltas into EvalStats).

    A *window* over the process-wide `MetricsRegistry` ``mapper.*``
    counters (core/obs.py), which are the single source of truth: each
    instance reports counts accumulated since its own construction, so
    `reset_matmul_cache_stats()` (which installs a fresh window) zeroes the
    view while the registry itself stays monotone for whole-process
    reporting."""

    _KEYS: ClassVar[Tuple[str, ...]] = ("memo_hits", "disk_hits", "misses",
                                        "evictions")

    def __init__(self) -> None:
        self._base: Dict[str, float] = {
            k: _REG.counter(f"mapper.{k}") for k in self._KEYS}

    def _window(self, k: str) -> int:
        return int(_REG.counter(f"mapper.{k}") - self._base[k])

    @property
    def memo_hits(self) -> int:     # served from the in-memory LRU
        return self._window("memo_hits")

    @property
    def disk_hits(self) -> int:     # served from the persistent layer
        return self._window("disk_hits")

    @property
    def misses(self) -> int:        # actually searched
        return self._window("misses")

    @property
    def evictions(self) -> int:     # LRU entries dropped at capacity
        return self._window("evictions")

    def summary(self) -> str:
        return (f"memo_hits={self.memo_hits} disk_hits={self.disk_hits} "
                f"misses={self.misses} evictions={self.evictions}")


_STATS = MapperCacheStats()

# global (device, shape) -> MatmulResult memo shared by the single-shape and
# batched entry points, so independent Evaluators never re-search a shape.
# Bounded LRU: at capacity the least-recently-used entry is evicted.
_MM_CACHE: "OrderedDict[Tuple[Any, ...], MatmulResult]" = OrderedDict()
_MM_CACHE_MAX = 1 << 17

_DISK: Optional[DiskCache] = None

#: the mapper's namespace under the cache root: the port's own, so that it
#: never serves an entry that another package wrote
NAMESPACE = "torch-mapper"


def _disk_cache() -> DiskCache:
    """The mapper's persistent namespace (lazy; follows result_cache's
    global root/enabled switches at every access)."""
    global _DISK
    if _DISK is None:
        _DISK = DiskCache(NAMESPACE)
    return _DISK


def matmul_cache_stats() -> MapperCacheStats:
    """Live hit/miss/eviction counters of the global matmul memo."""
    return _STATS


def reset_matmul_cache_stats() -> None:
    global _STATS
    _STATS = MapperCacheStats()


def _mm_cache_put(key: Tuple[Any, ...], r: MatmulResult) -> None:
    if key in _MM_CACHE:
        _MM_CACHE.move_to_end(key)
        _MM_CACHE[key] = r
        return
    while len(_MM_CACHE) >= _MM_CACHE_MAX:
        _MM_CACHE.popitem(last=False)
        _REG.inc("mapper.evictions")
    _MM_CACHE[key] = r


# canonical Device hash fragments are stable per process — memoize by the
# (hashable, frozen) Device itself
_DEVICE_KEYS: Dict[Device, str] = {}


def _pair_key(device: Device, shape: MatmulShape, tables: str) -> str:
    """Content hash of one (device, shape) search under the current model
    version and the table device `tables` it was solved on, so that a warm
    rerun serves the entries of its own cold path."""
    dk = _DEVICE_KEYS.get(device)
    if dk is None:
        dk = content_key(device, salt=MODEL_VERSION)
        _DEVICE_KEYS[device] = dk
    return content_key(dk, list(shape),
                       salt=f"{MODEL_VERSION}/mapper/{_DISK_SALT[tables]}")


def _result_to_doc(r: MatmulResult) -> Dict[str, Any]:
    mp = r.mapping
    return {"latency": r.latency, "flops": r.flops,
            "bytes": r.main_memory_bytes, "cands": r.candidates_searched,
            "mapping": [mp.tile_m, mp.tile_k, mp.tile_n, mp.subtile_m,
                        mp.subtile_k, mp.subtile_n, mp.scheme,
                        int(mp.double_buffer_l2), int(mp.double_buffer_l1),
                        mp.compute_time, mp.memory_time]}


def _result_from_doc(doc: Dict[str, Any]) -> Optional[MatmulResult]:
    try:
        tm, tk, tn, sm, sk, sn, scheme, db2, db1, ct, mt = doc["mapping"]
        return MatmulResult(
            latency=float(doc["latency"]), flops=int(doc["flops"]),
            main_memory_bytes=int(doc["bytes"]),
            mapping=Mapping(int(tm), int(tk), int(tn), int(sm), int(sk),
                            int(sn), int(scheme), bool(db2), bool(db1),
                            float(ct), float(mt)),
            candidates_searched=int(doc["cands"]))
    except (KeyError, TypeError, ValueError):
        return None                     # malformed entry: treat as a miss


def clear_matmul_cache(disk: bool = False) -> None:
    """Drop all memoized mapper results (cold-start benchmarking).

    By default only the in-memory LRU is cleared — the persistent layer
    keeps serving across-session warmth. Pass `disk=True` to also wipe the
    on-disk mapper namespace (honest cold-start measurement)."""
    _MM_CACHE.clear()
    if disk:
        _disk_cache().clear()


def is_memoized(device: Device, shape: MatmulShape) -> bool:
    """True if this (device, shape) pair is already in the in-memory memo."""
    return (device, shape) in _MM_CACHE


def matmul_perf_batch_multi(
        pairs: Sequence[Tuple[Device, MatmulShape]],
        device: str = "cuda") -> List[MatmulResult]:
    """Search the mapping space of many (device, shape) GEMM pairs in
    stacked passes — the device-axis generalization of `matmul_perf_batch`.

    All un-memoized pairs' feasible candidates are concatenated along one
    flat pairs x candidates axis — device scalars gathered per row exactly
    like shape scalars — and evaluated together (chunked to bound peak
    memory), the tables on `device`: ``"cuda"`` (the default) runs the
    kernel of ``kernels/mapper_tables`` and raises without a card,
    ``"cpu"`` runs numpy. A whole design-space Study (many Systems x models
    x workloads) pays one table call per chunk instead of one per device
    per shape. Results are identical to calling matmul_perf per pair, on
    either device.

    Lookup order per pair: in-memory LRU, then the content-hashed disk layer
    (previous sessions' searches), then the stacked search; fresh results
    are written through to both layers.
    """
    check_device(device)
    results: List[Optional[MatmulResult]] = [None] * len(pairs)
    pend_idx: List[int] = []
    pend_rows: List[Tuple[Any, ...]] = []
    pend_poks: List[Any] = []
    pend_dense: List[int] = []
    pend_keys: List[Optional[str]] = []
    budget = 0
    disk = _disk_cache()

    def flush() -> None:
        nonlocal budget
        if not pend_idx:
            return
        devs = [pairs[i][0] for i in pend_idx]
        shapes = [pairs[i][1] for i in pend_idx]
        _REG.inc("mapper.rows_feasible",
                 float(sum(r[0].size for r in pend_rows)))
        if _PRUNE == "off":
            use_rows: Sequence[Any] = pend_rows
            use_poks: Sequence[Any] = pend_poks
        else:
            use_rows, use_poks, n_pruned = _prune_pairs(
                devs, shapes, pend_rows, pend_poks, device)
            _REG.inc("mapper.rows_pruned", float(n_pruned))
        solved = _solve_chunk(devs, shapes, use_rows, use_poks, device)
        if _PRUNE == "oracle":
            full = _solve_chunk(devs, shapes, pend_rows, pend_poks, device)
            for (a, b), dev, shape in zip(zip(solved, full), devs, shapes):
                if a != b:
                    raise RuntimeError(
                        f"pruning oracle mismatch for matmul "
                        f"{shape[0]}x{shape[1]}x{shape[2]} on {dev.name}: "
                        f"pruned {a[0]!r}/{a[3]!r} != full {b[0]!r}/{b[3]!r}")
            solved = full
        for i, nd, key, (lat, flops, mm_bytes, mapping) in zip(
                pend_idx, pend_dense, pend_keys, solved):
            r = MatmulResult(latency=lat, flops=flops,
                             main_memory_bytes=mm_bytes,
                             mapping=mapping, candidates_searched=nd)
            results[i] = r
            _mm_cache_put(pairs[i], r)
            if key is not None:
                with _REG.phase("mapper.disk"):
                    disk.put(key, _result_to_doc(r))
        pend_idx.clear()
        pend_rows.clear()
        pend_poks.clear()
        pend_dense.clear()
        pend_keys.clear()
        budget = 0

    for i, (hw, shape) in enumerate(pairs):
        hit = _MM_CACHE.get((hw, shape))
        if hit is not None:
            _MM_CACHE.move_to_end((hw, shape))
            _REG.inc("mapper.memo_hits")
            results[i] = hit
            continue
        key: Optional[str] = None
        if disk.enabled:
            with _REG.phase("mapper.disk"):
                key = _pair_key(hw, shape, device)
                doc = disk.get(key)
            r = _result_from_doc(doc) if doc is not None else None
            if r is not None:
                _REG.inc("mapper.disk_hits")
                _mm_cache_put((hw, shape), r)
                results[i] = r
                continue
        _REG.inc("mapper.misses")
        with _REG.phase("mapper.candidates"):
            cols, p_ok, n_dense = _candidate_rows(hw, shape)
        pend_idx.append(i)
        pend_rows.append(cols)
        pend_poks.append(p_ok)
        pend_dense.append(n_dense)
        pend_keys.append(key)
        budget += cols[0].size
        if budget >= _CHUNK_ROWS:
            flush()
    flush()
    return cast(List[MatmulResult], results)


def matmul_perf_batch(hw: Device, shapes: Sequence[MatmulShape],
                      device: str = "cuda") -> List[MatmulResult]:
    """Search the mapping space of many GEMM shapes of one hardware Device
    `hw` in stacked passes (the single-device view of
    `matmul_perf_batch_multi`), the tables on `device`."""
    return matmul_perf_batch_multi([(hw, s) for s in shapes], device=device)


@functools.lru_cache(maxsize=1 << 12)
def _search(device: Device, shape: MatmulShape) -> MatmulResult:
    """One (device, shape) pair's search on numpy, memoized per process: the
    batched path's pruning, tables and winner pick, without its memo and
    disk layers."""
    cols, p_ok, n_dense = _candidate_rows(device, shape)
    rows, poks = [cols], [p_ok]
    if cols[0].size and _PRUNE != "off":
        rows, poks, _ = _prune_pairs([device], [shape], rows, poks, "cpu")
    lat, flops, mm_bytes, mapping = _solve_chunk([device], [shape], rows,
                                                 poks, "cpu")[0]
    return MatmulResult(latency=lat, flops=flops, main_memory_bytes=mm_bytes,
                        mapping=mapping, candidates_searched=n_dense)


def matmul_perf(device: Device, m: int, k: int, n: int,
                batch: int = 1, bytes_a: float = 2, bytes_b: float = 2,
                bytes_out: float = 2, bytes_acc: float = 2,
                b_shared: bool = False,
                mac_scale: float = 1.0) -> MatmulResult:
    """Search the mapping space and return the best predicted latency, on
    numpy, memoized per (device, shape) in this process.

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


def matmul_perf_reference(device: Device, m: int, k: int, n: int,
                          batch: int = 1, bytes_a: float = 2,
                          bytes_b: float = 2, bytes_out: float = 2,
                          bytes_acc: float = 2, b_shared: bool = False,
                          mac_scale: float = 1.0) -> MatmulResult:
    """The original dense broadcast search, kept as the equivalence oracle
    for the compressed/batched engine — it evolves in lock-step with the
    engine (per-operand widths + mac_scale) but keeps the seed's
    evaluate-everything structure: every candidate including infeasible ones
    is priced (masked to inf)."""
    dev = device
    sa = dev.core.lane.systolic_array
    lanes = dev.core.lanes
    freq = dev.frequency_hz

    # ---------------- candidate axes ----------------
    tm = _tile_candidates(m, min(sa.rows, m))
    tk = _tile_candidates(k, min(128, k))
    tn = _tile_candidates(n, min(sa.cols, n))
    sm = _tile_candidates(m, min(sa.rows, m))
    sk = _tile_candidates(k, min(64, k))
    sn = _tile_candidates(n, min(sa.cols, n))

    # level-2 tile grid  [i2]
    TM, TK, TN = np.meshgrid(tm, tk, tn, indexing="ij")
    TM, TK, TN = TM.ravel(), TK.ravel(), TN.ravel()
    # level-1 subtile grid  [i1]
    SM, SK, SN = np.meshgrid(sm, sk, sn, indexing="ij")
    SM, SK, SN = SM.ravel(), SK.ravel(), SN.ravel()

    # pipeline options: (db2, db1) in {0,1}^2  [p]
    DB = np.array(_DB_OPTIONS, dtype=np.int64)

    # broadcast to [i2, i1, p]
    TM_, TK_, TN_ = (x[:, None, None] for x in (TM, TK, TN))
    SM_, SK_, SN_ = (x[None, :, None] for x in (SM, SK, SN))
    DB2 = DB[None, None, :, 0]
    DB1 = DB[None, None, :, 1]

    # ---------------- validity masks ----------------
    gb_need = (TM_ * TK_ * bytes_a + TK_ * TN_ * bytes_b
               + TM_ * TN_ * bytes_acc) * (1 + DB2)
    lb_need = (SM_ * SK_ * bytes_a + SK_ * SN_ * bytes_b
               + SM_ * SN_ * bytes_acc) * (1 + DB1)
    valid = (gb_need <= dev.global_buffer_bytes) \
        & (lb_need <= dev.core.local_buffer_bytes) \
        & (SM_ <= TM_) & (SK_ <= TK_) & (SN_ <= TN_)
    if batch > 1:
        # subtiles/tiles must not span batch elements
        valid = valid & (SM_ <= m) & (TM_ <= m)

    # ---------------- level 0: core compute time for one subtile ----------
    # subtile split across lanes on the N dimension
    sn_lane = -(-SN_ // lanes)           # ceil
    lane_cyc = gemm_cycles_array(SM_, SK_, sn_lane, sa.rows, sa.cols)
    # narrow-datatype issue rate (power-of-two scale: division is exact)
    lane_cyc = np.ceil(lane_cyc / mac_scale).astype(np.int64)
    subtile_cyc = lane_cyc               # lanes run in parallel

    # ---------------- level 1: schedule subtiles across cores -------------
    n_sub_m = -(-TM_ // SM_)
    n_sub_n = -(-TN_ // SN_)
    n_sub_k = -(-TK_ // SK_)
    cores = dev.core_count
    gb_bw_cyc = dev.global_buffer_bw_per_cycle

    # -- scheme 1: distinct C subtiles per core, k-loop inside core --------
    out_subtiles = n_sub_m * n_sub_n
    waves = -(-out_subtiles // cores)
    w = np.minimum(out_subtiles, cores)
    gm = np.minimum(n_sub_m,
                    np.maximum(1, np.round(np.sqrt(w))).astype(np.int64))
    gn = np.minimum(n_sub_n, np.maximum(1, -(-w // gm)))
    wave_traffic = gm * SM_ * TK_ * bytes_a + gn * TK_ * SN_ * bytes_b \
        + gm * gn * SM_ * SN_ * bytes_out
    wave_mem_cyc = -(-wave_traffic // gb_bw_cyc)
    wave_cmp_cyc = n_sub_k * subtile_cyc
    s1_cyc = np.where(DB1 == 1,
                      waves * np.maximum(wave_mem_cyc, wave_cmp_cyc)
                      + np.minimum(wave_mem_cyc, wave_cmp_cyc),
                      waves * (wave_mem_cyc + wave_cmp_cyc))

    # -- scheme 2: split K of each C subtile across spare cores ------------
    ck = np.maximum(1, np.minimum(cores // np.maximum(out_subtiles, 1),
                                  n_sub_k))
    k_per_core = -(-n_sub_k // ck)
    s2_cmp_cyc = k_per_core * subtile_cyc
    # reduction: partials written + read through GB, summed on vector units
    vec_tp = dev.core.lanes * dev.core.lane.vector_unit.width
    red_traffic = (2 * (ck - 1)) * SM_ * SN_ * bytes_acc
    red_cyc = -(-red_traffic // gb_bw_cyc) + \
        -(-((ck - 1) * SM_ * SN_) // np.maximum(vec_tp * cores, 1))
    s2_waves = -(-(out_subtiles * ck) // cores)
    s2_traffic = SM_ * TK_ * bytes_a + TK_ * SN_ * bytes_b  # per subtile grp
    s2_mem_cyc = -(-(s2_traffic * out_subtiles
                     // np.maximum(s2_waves, 1)) // gb_bw_cyc)
    s2_cyc = np.where(DB1 == 1,
                      s2_waves * np.maximum(s2_mem_cyc, s2_cmp_cyc),
                      s2_waves * (s2_mem_cyc + s2_cmp_cyc)) + red_cyc

    use_s2 = s2_cyc < s1_cyc
    tile_cyc = np.where(use_s2, s2_cyc, s1_cyc)
    tile_time = tile_cyc / freq

    # ---------------- level 2: main memory <-> global buffer --------------
    n_t_m = -(-m // np.minimum(TM_, m))
    n_t_n = -(-n // np.minimum(TN_, n))
    n_t_k = -(-k // np.minimum(TK_, k))
    steps = batch * n_t_m * n_t_n * n_t_k
    # IO per step: A tile + B tile; C written once per (m,n) tile
    a_bytes_step = TM_ * TK_ * bytes_a
    b_bytes_step = TK_ * TN_ * bytes_b
    c_bytes_tile = TM_ * TN_ * bytes_out
    mem_bw = dev.memory_bandwidth
    step_mem_t = (a_bytes_step + b_bytes_step) / mem_bw
    c_mem_t = c_bytes_tile / mem_bw
    if b_shared and batch > 1:
        # B re-read only once per k-sweep regardless of batch
        step_mem_t = (a_bytes_step + b_bytes_step / batch) / mem_bw

    step_t = np.where(DB2 == 1,
                      np.maximum(step_mem_t, tile_time),
                      step_mem_t + tile_time)
    total_t = steps * step_t + batch * n_t_m * n_t_n * c_mem_t \
        + np.where(DB2 == 1, np.minimum(step_mem_t, tile_time), 0.0)

    total_t = np.where(valid, total_t, np.inf)

    # ---------------- pick the winner ----------------
    flat = int(np.argmin(total_t))
    i2, i1, p = np.unravel_index(flat, total_t.shape)
    best_t = float(total_t[i2, i1, p])
    if not np.isfinite(best_t):
        raise ValueError(
            f"no valid mapping for matmul {m}x{k}x{n} on {dev.name} "
            f"(buffers too small?)")

    flops = 2 * batch * m * k * n
    # actual main-memory traffic of the chosen mapping
    mm_bytes = int(batch * (n_t_m * n_t_n * n_t_k)[i2, 0, 0]
                   * (TM[i2] * TK[i2] * bytes_a + TK[i2] * TN[i2] * bytes_b)
                   + batch * (n_t_m * n_t_n)[i2, 0, 0] * TM[i2] * TN[i2]
                   * bytes_out)

    mapping = Mapping(
        tile_m=int(TM[i2]), tile_k=int(TK[i2]), tile_n=int(TN[i2]),
        subtile_m=int(SM[i1]), subtile_k=int(SK[i1]), subtile_n=int(SN[i1]),
        scheme=2 if bool(use_s2[i2, i1, p]) else 1,
        double_buffer_l2=bool(DB2[0, 0, p]),
        double_buffer_l1=bool(DB1[0, 0, p]),
        compute_time=float((steps * tile_time)[i2, i1, p]),
        memory_time=float((steps * step_mem_t)[i2, 0, 0]
                          + (batch * n_t_m * n_t_n * c_mem_t)[i2, 0, 0]),
    )
    n_cand = int(total_t.size)
    return MatmulResult(latency=best_t, flops=flops,
                        main_memory_bytes=mm_bytes, mapping=mapping,
                        candidates_searched=n_cand)
